"""Port parity: prefill attention (``layers.flash_attention`` and the
plain version of the ``flash_fwd`` kernel).

The reference's Pallas ``flash_fwd`` does not run under this JAX
(``pl.load`` is gone, ROADMAP queue 3), so the port is held against the
reference's ``layers.flash_attention``, the function that kernel computes,
on the same numpy inputs: the four shapes of
``tests/test_perf_opts.py::test_flash_kernel_matches_reference`` (window
64, KV = H, KV = 1), a ragged Sq, a decode-style q_offset, the wide
head dims (160 with GQA, 128 with g = 3 and a window), and whisper's and
pixtral's serve shapes (non-causal with Sq != Sk and Sk = 1500, Sq = 1,
the encoder's 1500 x 1500; hd 160 at S 768), and MLA's q/k of 96 with v
of 64 (minicpm3), causal, windowed and after a cache (q_offset).
Tolerances: f32 to the reference test's 2e-5; bf16 to one bf16 ulp of the
reference's output (plus 1e-6 for values near zero), since both round the
same f32 result once.  The kernel itself is held against the plain version
on the card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``;
the bf16 kernel's tile arithmetic is emulated here in plain PyTorch
(``_mma_tile_emulation``) and held to the same one-ulp gate.

    PYTHONPATH=src python tests/test_torch_flash.py

prints how many outputs of the serve shape (B 8, S 512, 14 q / 2 KV heads,
hd 64, causal) each way of feeding P to the bf16 tensor cores puts outside
that gate.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.models.layers import flash_attention as ref_flash_attention
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import flash_attention

SHAPES = [  # B, Sq, Sk, H, KV, hd, causal, window, q_offset
    (2, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 128, 128, 8, 8, 32, True, 64, 0),
    (2, 256, 256, 4, 1, 128, False, 0, 0),
    (1, 512, 512, 2, 2, 64, True, 0, 0),
    (2, 100, 100, 14, 2, 64, True, 0, 0),       # Sq not a multiple of 64
    (1, 37, 600, 4, 2, 32, True, 0, 563),       # queries after a cache
    (1, 96, 96, 4, 2, 160, True, 0, 0),         # hd 160 GQA (pixtral)
    (1, 80, 80, 6, 2, 128, True, 32, 0),        # hd 128, g = 3, window
    # whisper: cross-attention at Sq != Sk and Sk = 1500 (its last 64-key
    # tile holds 28 keys), the cross decode at Sq = 1, the encoder's
    # 1500 x 1500 without a mask (past the reference's 1024-row q chunk)
    (1, 40, 1500, 2, 2, 64, False, 0, 0),
    (2, 1, 1500, 4, 4, 64, False, 0, 0),
    (1, 1500, 1500, 1, 1, 64, False, 0, 0),
    (1, 768, 768, 4, 1, 160, True, 0, 0),       # pixtral: 256 + 512, hd 160
    # MLA (minicpm3): q/k 96 (64 + rope 32), v 64, KV = H
    (1, 128, 128, 4, 4, (96, 64), True, 0, 0),
    (1, 100, 100, 4, 4, (96, 64), True, 32, 0),  # ragged, window
    (1, 20, 150, 2, 2, (96, 64), True, 0, 130),  # queries after a cache
]


def _hd(hd) -> tuple[int, int]:
    """(q/k head dim, v head dim) of a SHAPES entry: an int is both."""
    return (hd, hd) if isinstance(hd, int) else tuple(hd)


IDS = [f"B{s[0]}-Sq{s[1]}-Sk{s[2]}-H{s[3]}-KV{s[4]}-hd{s[5]}-"
       f"{'causal' if s[6] else 'full'}-w{s[7]}-off{s[8]}"
       if isinstance(s[5], int) else
       f"B{s[0]}-Sq{s[1]}-Sk{s[2]}-H{s[3]}-KV{s[4]}-hd{s[5][0]}v{s[5][1]}-"
       f"{'causal' if s[6] else 'full'}-w{s[7]}-off{s[8]}" for s in SHAPES]


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    hd, hd_v = _hd(hd)
    rng = np.random.default_rng(seed + Sq + H)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd_v), dtype=np.float32)
    return q, k, v


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,win,off", SHAPES, ids=IDS)
def test_flash_attention_matches_reference_f32(B, Sq, Sk, H, KV, hd, causal,
                                               win, off):
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd)
    want = np.asarray(ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=win, q_offset=off))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    ops.reset_counts()
    for backend in ("cuda", "torch"):    # "cuda" on CPU tensors: plain route
        got = flash_attention(tq, tk, tv, causal=causal, window=win,
                              q_offset=off, backend=backend)
        assert got.dtype == torch.float32 and got.shape == (B, Sq, H,
                                                             _hd(hd)[1])
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the CPU tensor took the kernel's plain version, and launched nothing
    assert ops.PLAIN_CALLS["flash_fwd"] == 1 and ops.LAUNCHES["flash_fwd"] == 0


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,win,off", SHAPES[:2] +
                         SHAPES[4:5] + SHAPES[6:], ids=IDS[:2] + IDS[4:5] +
                         IDS[6:])
def test_flash_attention_matches_reference_bf16(B, Sq, Sk, H, KV, hd, causal,
                                                win, off):
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = torch.as_tensor(np.asarray(ref_flash_attention(
        jq, jk, jv, causal=causal, window=win, q_offset=off)
        .astype(jnp.float32)))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=win, q_offset=off)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert bool((err <= _bf16_ulp(want) + 1e-6).all()), float(err.max())


def test_flash_ref_matches_naive_softmax():
    """The plain version against one dense softmax (no chunking)."""
    B, S, H, KV, hd = 2, 70, 6, 3, 32
    q, k, v = (torch.as_tensor(a) for a in _inputs(B, S, S, H, KV, hd))
    got = ref.flash_fwd_ref(q, k, v, causal=True, window=16, chunk=32,
                            q_chunk=24)
    kk = k.repeat_interleave(H // KV, dim=2)
    vv = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - 16)), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)



# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's arithmetic (csrc/flash_fwd.cu), emulated
# ---------------------------------------------------------------------------

def _bf16_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated to bf16 (its top 16 bits), as an f32 tensor."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split_p(p: torch.Tensor, how: str) -> list:
    """The bf16 parts the kernel feeds to P.V for P: ``exact3`` (the
    kernel's split3_bf16: hi + mid + lo == p exactly), ``round2``
    (bf16(p) + bf16(p - bf16(p))) or ``round1`` (bf16(p) alone)."""
    if how == "exact3":
        hi = _bf16_trunc(p)
        mid = _bf16_trunc(p - hi)
        return [hi, mid, p - hi - mid]
    hi = p.bfloat16().float()
    return [hi] if how == "round1" else [hi, (p - hi).bfloat16().float()]


def _mma_tile_emulation(q, k, v, *, causal, window, q_offset, how="exact3"):
    """The bf16 kernel's arithmetic in plain PyTorch: 64-key tiles, bf16
    operands (exact products) with f32 sums, the online softmax on unscaled
    scores with p = 2^(s c - m c), p = 0 on invalid keys, and P fed to P.V
    in the bf16 parts of ``_split_p``; the scale is that of q/k's width.
    Returns bf16 [B, Sq, H, hd_v]."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    c = math.log2(math.e) / math.sqrt(hd)
    neg = ref.NEG
    qf = q.float().permute(0, 2, 1, 3)                       # [B, H, Sq, hd]
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    pos = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), neg)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, v.shape[-1]))
    for t0 in range(0, Sk, 64):
        j = t0 + torch.arange(min(64, Sk - t0))[None, :]
        valid = torch.ones((Sq, j.shape[1]), dtype=torch.bool)
        if causal:
            valid &= j <= pos
        if window > 0:
            valid &= j > pos - window
        s = torch.where(valid, qf @ kf[:, :, t0:t0 + 64].transpose(-1, -2),
                        neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        mc = torch.where(m_new == neg, 0.0, m_new) * c
        p = torch.where(valid, torch.exp2(s * c - mc), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr
        for part in _split_p(p, how):
            o = o + part @ vf[:, :, t0:t0 + 64]
        m = m_new
    out = o / l.clamp(min=1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _outside_gate(got: torch.Tensor, want: torch.Tensor) -> int:
    err = (got.float() - want.float()).abs()
    return int((err > _bf16_ulp(want.float()) + 1e-6).sum())


def _bf16_case(B, Sq, Sk, H, KV, hd, seed=1):
    return tuple(torch.as_tensor(a).to(torch.bfloat16)
                 for a in _inputs(B, Sq, Sk, H, KV, hd, seed=seed))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,win,off", SHAPES, ids=IDS)
def test_mma_tile_arithmetic_holds_the_bf16_gate(B, Sq, Sk, H, KV, hd, causal,
                                                 win, off):
    """64-key tiles, bf16 products with f32 sums and P split exactly into
    three bf16 parts stay within one bf16 ulp (+1e-6) of the plain
    version."""
    q, k, v = _bf16_case(B, Sq, Sk, H, KV, hd)
    kw = dict(causal=causal, window=win, q_offset=off)
    got = _mma_tile_emulation(q, k, v, **kw)
    assert got.shape == (B, Sq, H, _hd(hd)[1])
    assert torch.isfinite(got.float()).all()
    assert _outside_gate(got, ref.flash_fwd_ref(q, k, v, **kw)) == 0


def test_rounding_p_to_bf16_breaks_the_gate():
    """Why the kernel splits P: feeding bf16(P) alone to P.V puts outputs
    outside the one-ulp gate (PERF.md gives the share at the serve
    shape)."""
    B, Sq, Sk, H, KV, hd, causal, win, off = SHAPES[4]
    q, k, v = _bf16_case(B, Sq, Sk, H, KV, hd)
    kw = dict(causal=causal, window=win, q_offset=off)
    want = ref.flash_fwd_ref(q, k, v, **kw)
    assert _outside_gate(_mma_tile_emulation(q, k, v, **kw, how="round1"),
                         want) > 0
    assert _outside_gate(_mma_tile_emulation(q, k, v, **kw), want) == 0


if __name__ == "__main__":
    q, k, v = _bf16_case(8, 512, 512, 14, 2, 64, seed=0)
    want = ref.flash_fwd_ref(q, k, v)
    for how in ("round1", "round2", "exact3"):
        n = _outside_gate(_mma_tile_emulation(q, k, v, causal=True, window=0,
                                              q_offset=0, how=how), want)
        print(f"serve shape, P as {how}: {n} of {want.numel()} outputs "
              f"outside one bf16 ulp + 1e-6 ({100 * n / want.numel():.2f} %)")
