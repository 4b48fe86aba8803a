"""Port parity: the Mamba2 SSD scan (the plain version of the ``ssd_fwd``
kernel, and ``ssm._ssd_chunked`` around it).

The same numpy inputs go through the reference's Pallas ``ssd_fwd`` (in
interpret mode, as ``tests/test_ssd_kernel.py`` runs it, on that file's
three shapes), its naive recurrence, and its ``_ssd_chunked`` (with S not
a multiple of the chunk and D != 0).  Tolerance 2e-4, the reference
test's: the chunked algebra sums in another order than the recurrence.
The kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``; its arithmetic
(TF32 tensor-core products with each operand split hi + lo, f32 sums in
its tile order) is emulated here in plain PyTorch (``_split_tf32_scan``)
and held to the same 2e-4 gate.

    PYTHONPATH=src python tests/test_torch_ssd.py

prints how many outputs of the serve shape (B 8, S 512, 32 heads, hd 64,
N 128, Q 64) each way of feeding the tensor cores puts outside that gate.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.ssd import ssd_fwd as ref_ssd_fwd
from repro.models.ssm import _ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.models.ssm import _ssd_chunked

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(B, S, H, hd, N, seed=0):
    """xh, dt (post-softplus), a_log, B, C, D as f32 numpy arrays."""
    rng = np.random.default_rng(seed + S + H)
    xh = rng.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = (rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.4).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return xh, dt, a_log, Bm, Cm, D


def _kernel_inputs(xh, dt, a_log, Bm, Cm):
    """The scan's inputs in the port's layout: dt folded into x, dA."""
    A = -np.exp(a_log)
    return (torch.as_tensor(xh * dt[..., None]),
            torch.as_tensor(dt * A[None, None, :]),
            torch.as_tensor(Bm), torch.as_tensor(Cm))


@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 64),
    (1, 96, 1, 64, 32, 32),
])
def test_ssd_ref_matches_reference_kernel(B, S, H, hd, N, chunk):
    xh, dt, a_log, Bm, Cm, _ = _inputs(B, S, H, hd, N)
    x, dA, tb, tc = _kernel_inputs(xh, dt, a_log, Bm, Cm)
    # the reference kernel's head-major layout, with B/C broadcast per head
    hm = (lambda t: np.asarray(t).transpose(0, 2, 1, *range(3, t.ndim))
          .reshape(B * H, S, *t.shape[3:]))
    bh = (lambda m: np.broadcast_to(m[:, None], (B, H, S, N))
          .reshape(B * H, S, N))
    y_k, st_k = ref_ssd_fwd(jnp.asarray(hm(x.numpy())),
                            jnp.asarray(hm(dA.numpy())), jnp.asarray(bh(Bm)),
                            jnp.asarray(bh(Cm)), chunk=chunk)
    y, st = ref.ssd_fwd_ref(x, dA, tb, tc, chunk=chunk)
    np.testing.assert_allclose(hm(y.numpy()), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(st.reshape(B * H, hd, N).numpy(),
                               np.asarray(st_k), **TOL)


def test_ssd_ref_matches_naive_recurrence():
    B, S, H, hd, N = 2, 40, 3, 8, 4
    xh, dt, a_log, Bm, Cm, _ = _inputs(B, S, H, hd, N)
    x, dA, tb, tc = _kernel_inputs(xh, dt, a_log, Bm, Cm)
    state = np.zeros((B, H, hd, N))
    ys = []
    for t in range(S):
        state = (state * np.exp(dA[:, t].numpy())[..., None, None]
                 + np.einsum("bhd,bn->bhdn", x[:, t].numpy(), Bm[:, t]))
        ys.append(np.einsum("bhdn,bn->bhd", state, Cm[:, t]))
    y, st = ref.ssd_fwd_ref(x, dA, tb, tc, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), **TOL)
    np.testing.assert_allclose(st.numpy(), state, **TOL)


@pytest.mark.parametrize("S,chunk", [(50, 16), (16, 64)])
def test_ssd_chunked_matches_reference(S, chunk):
    """Zero-padding to the chunk, the dt fold and the D skip term."""
    B, H, hd, N = 2, 4, 16, 8
    xh, dt, a_log, Bm, Cm, D = _inputs(B, S, H, hd, N, seed=3)
    y_r, st_r = ref_ssd_chunked(*(jnp.asarray(a) for a in
                                  (xh, dt, a_log, Bm, Cm, D)), chunk)
    ops.reset_counts()
    for backend in ("cuda", "torch"):    # "cuda" on CPU tensors: plain route
        y, st = _ssd_chunked(*(torch.as_tensor(a) for a in
                               (xh, dt, a_log, Bm, Cm, D)), chunk,
                             backend=backend)
        assert y.shape == (B, S, H, hd) and st.shape == (B, H, hd, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), **TOL)
    assert ops.PLAIN_CALLS["ssd_fwd"] == 1 and ops.LAUNCHES["ssd_fwd"] == 0


def test_ssd_ref_rejects_a_ragged_sequence():
    x, dA, tb, tc = _kernel_inputs(*_inputs(1, 20, 2, 8, 4)[:5])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssd_fwd_ref(x, dA, tb, tc, chunk=16)



# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (csrc/ssd_fwd.cu), emulated
# ---------------------------------------------------------------------------

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernel rounds a high part: add half an ulp to the
    magnitude bits and clear the 13 low ones."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """a truncated to TF32, as the tensor cores read an operand whose 13
    low bits are not clear (the kernel's low parts)."""
    return (a.view(torch.int32) & -0x2000).view(torch.float32)


def _mma(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         how: str) -> torch.Tensor:
    """d + a @ b in 8-deep steps of mma.sync m16n8k8, each step's product
    summed from zero and added to d (the kernel's f32 add), its operands
    fed as ``how`` says: ``split3`` (per operand hi = tf32(a) rounded and
    lo = a - hi truncated to TF32; lo.hi + hi.lo + hi.hi, the kernel's),
    ``tf32`` (one rounded term) or ``f32`` (unrounded)."""
    for k in range(0, a.shape[-1], 8):
        ak, bk = a[..., k:k + 8], b[..., k:k + 8, :]
        if how == "f32":
            d = d + ak @ bk
            continue
        ah, bh = _tf32(ak), _tf32(bk)
        t = ah @ bh
        if how == "split3":
            t = (_tf32_trunc(ak - ah) @ bh + ah @ _tf32_trunc(bk - bh)) + t
        d = d + t
    return d


def _split_tf32_scan(x, dA, Bm, Cm, *, chunk, how="split3"):
    """The scan kernel's arithmetic in plain PyTorch, per (sequence, head):
    cumsum(dA) sequential, as the kernel's; G = C B^T in f32; per 16-row
    query tile, C S^T summed over the NH state
    column groups in the kernel's order (the tile's finishing warp first,
    then the others ascending), scaled by exp(cs), then ((G o L) x) added
    over the key steps up to the diagonal; the state scaled by exp(cs_Q),
    then (x o w)^T B added.  Every product through ``_mma``."""
    Bt, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    DT = hd // 16
    NH = min(8, DT * (N // 8)) // DT
    NN = N // NH
    xh = x.permute(0, 2, 1, 3)                                # [Bt,H,S,hd]
    da = dA.permute(0, 2, 1)                                  # [Bt,H,S]
    st = torch.zeros((Bt, H, hd, N))
    y = torch.empty((Bt, H, S, hd))
    for c0 in range(0, S, Q):
        xq = xh[:, :, c0:c0 + Q]
        bq, cq = Bm[:, None, c0:c0 + Q], Cm[:, None, c0:c0 + Q]
        cs = torch.cumsum(da[:, :, c0:c0 + Q], dim=-1)        # [Bt,H,Q]
        g = cq @ bq.transpose(-1, -2)                         # f32 FMA
        i = torch.arange(Q)
        m = torch.where(i[:, None] >= i[None, :],
                        g * torch.exp(cs[..., :, None] - cs[..., None, :]),
                        0.0)
        part = [_mma(torch.zeros((Bt, H, Q, hd)), cq[..., h * NN:(h + 1) * NN],
                     st[..., h * NN:(h + 1) * NN].transpose(-1, -2), how)
                for h in range(NH)]
        for mi in range(0, Q, 16):
            t = mi // 16
            own = NH - 1 - t % NH if (t // NH) % 2 else t % NH
            rows = slice(mi, min(mi + 16, Q))
            acc = part[own][..., rows, :]
            for h in range(NH):
                if h != own:
                    acc = acc + part[h][..., rows, :]
            acc = acc * torch.exp(cs[..., rows])[..., None]
            keys = min(mi + 16, Q)
            y[:, :, c0 + mi:c0 + keys] = _mma(acc, m[..., rows, :keys],
                                              xq[..., :keys, :], how)
        w = torch.exp(cs[..., -1:] - cs)                      # [Bt,H,Q]
        st = st * torch.exp(cs[..., -1])[..., None, None]
        st = _mma(st, (xq * w[..., None]).transpose(-1, -2), bq, how)
    return y.permute(0, 2, 1, 3), st


def _outside_gate(got: torch.Tensor, want: torch.Tensor) -> int:
    """Outputs outside ``assert_close``'s 2e-4 gate (atol and rtol)."""
    return int(((got - want).abs() > 2e-4 + 2e-4 * want.abs()).sum())


@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (2, 128, 2, 32, 16, 64),
    (1, 128, 2, 64, 128, 64),
    (1, 60, 2, 32, 128, 20),
])
def test_split_tf32_arithmetic_holds_the_gate(B, S, H, hd, N, chunk):
    """TF32 products with each operand split hi + lo (three products for
    one) and f32 sums in the kernel's tile order stay within 2e-4 of the
    plain version."""
    x, dA, tb, tc = _kernel_inputs(*_inputs(B, S, H, hd, N)[:5])
    y, st = _split_tf32_scan(x, dA, tb, tc, chunk=chunk)
    y_p, st_p = ref.ssd_fwd_ref(x, dA, tb, tc, chunk=chunk)
    assert y.shape == y_p.shape and st.shape == st_p.shape
    torch.testing.assert_close(y, y_p, **TOL)
    torch.testing.assert_close(st, st_p, **TOL)


def test_one_term_tf32_breaks_the_gate():
    """Why the kernel splits its operands: one TF32 product per product
    puts outputs outside the 2e-4 gate (PERF.md gives the share at the
    serve shape)."""
    x, dA, tb, tc = _kernel_inputs(*_inputs(1, 128, 2, 64, 128)[:5])
    y_p, st_p = ref.ssd_fwd_ref(x, dA, tb, tc, chunk=64)
    y, st = _split_tf32_scan(x, dA, tb, tc, chunk=64, how="tf32")
    assert _outside_gate(y, y_p) + _outside_gate(st, st_p) > 0
    y, st = _split_tf32_scan(x, dA, tb, tc, chunk=64)
    assert _outside_gate(y, y_p) + _outside_gate(st, st_p) == 0


if __name__ == "__main__":
    x, dA, tb, tc = _kernel_inputs(*_inputs(8, 512, 32, 64, 128)[:5])
    y_p, st_p = ref.ssd_fwd_ref(x, dA, tb, tc, chunk=64)
    n_out = y_p.numel() + st_p.numel()
    for how in ("tf32", "split3", "f32"):
        y, st = _split_tf32_scan(x, dA, tb, tc, chunk=64, how=how)
        n = _outside_gate(y, y_p) + _outside_gate(st, st_p)
        print(f"serve shape, products as {how}: {n} of {n_out} outputs "
              f"outside 2e-4 (atol and rtol) ({100 * n / n_out:.4f} %); "
              f"max abs y {float((y - y_p).abs().max()):.3g}, state "
              f"{float((st - st_p).abs().max()):.3g}")
