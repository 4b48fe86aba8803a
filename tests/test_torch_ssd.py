"""Port parity: the Mamba2 SSD scan (the plain version of the ``ssd_fwd``
kernel, and ``ssm._ssd_chunked`` around it).

The same numpy inputs go through the reference's Pallas ``ssd_fwd`` (in
interpret mode, as ``tests/test_ssd_kernel.py`` runs it, on that file's
three shapes), its naive recurrence, and its ``_ssd_chunked`` (with S not
a multiple of the chunk and D != 0).  Tolerance 2e-4, the reference
test's: the chunked algebra sums in another order than the recurrence.
The kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
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

