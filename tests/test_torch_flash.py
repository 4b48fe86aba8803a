"""Port parity: prefill attention (``layers.flash_attention`` and the
plain version of the ``flash_fwd`` kernel).

The reference's Pallas ``flash_fwd`` does not run under this JAX
(``pl.load`` is gone, ROADMAP queue 3), so the port is held against the
reference's ``layers.flash_attention``, the function that kernel computes,
on the same numpy inputs: the four shapes of
``tests/test_perf_opts.py::test_flash_kernel_matches_reference`` (window
64, KV = H, KV = 1), a ragged Sq, and a decode-style q_offset.
Tolerances: f32 to the reference test's 2e-5; bf16 to one bf16 ulp of the
reference's output (plus 1e-6 for values near zero), since both round the
same f32 result once.  The kernel itself is held against the plain version
on the card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
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
]
IDS = [f"B{s[0]}-Sq{s[1]}-Sk{s[2]}-H{s[3]}-KV{s[4]}-hd{s[5]}-"
       f"{'causal' if s[6] else 'full'}-w{s[7]}-off{s[8]}" for s in SHAPES]


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed + Sq + H)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
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
        assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the CPU tensor took the kernel's plain version, and launched nothing
    assert ops.PLAIN_CALLS["flash_fwd"] == 1 and ops.LAUNCHES["flash_fwd"] == 0


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,win,off", SHAPES[:2] +
                         SHAPES[4:5], ids=IDS[:2] + IDS[4:5])
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

