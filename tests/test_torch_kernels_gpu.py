"""The models' prefill kernels against their plain versions, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_gpu.py

Every case is marked ``cuda`` and skips without a CUDA GPU (the kernels
have no CPU mode; their plain versions are held against the reference by
``tests/test_torch_flash.py`` and ``tests/test_torch_ssd.py``).
Tolerances: ``flash_fwd`` in f32 to 2e-5 and in bf16 to one bf16 ulp (plus
1e-6 near zero); ``ssd_fwd`` to 2e-4 (atol and rtol) -- both sum in
another order than their plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

FLASH_SHAPES = [  # B, Sq, Sk, H, KV, hd, causal, window, q_offset
    (2, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 128, 128, 8, 8, 32, True, 64, 0),
    (2, 100, 100, 14, 2, 64, True, 0, 0),
    (2, 130, 130, 4, 1, 64, False, 0, 0),
    (1, 37, 600, 4, 2, 32, True, 0, 563),
    # the tensor-core kernel's tile edges (64 query rows, 64-key tiles)
    (1, 65, 65, 4, 2, 64, True, 0, 0),
    (2, 127, 127, 4, 2, 64, True, 0, 0),
    (1, 65, 127, 4, 2, 64, True, 0, 62),
    (1, 100, 300, 4, 2, 64, False, 0, 0),      # non-causal, Sk > Sq
    (1, 200, 200, 4, 2, 32, False, 64, 0),     # hd 32, window, non-causal
    (1, 512, 512, 14, 2, 64, True, 0, 0),      # the serve shape at B 1
    (1, 256, 256, 8, 1, 64, True, 0, 0),       # KV = 1
]
SSD_SHAPES = [  # B, S, H, hd, N, chunk
    (2, 128, 4, 32, 16, 64), (1, 96, 3, 64, 128, 32), (2, 64, 2, 64, 128, 16),
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only there")
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,win,off", FLASH_SHAPES)
def test_flash_kernel_matches_plain(gpu, dtype, B, Sq, Sk, H, KV, hd, causal,
                                    win, off):
    rng = np.random.default_rng(Sq + H)
    q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32),
                               device=gpu).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    n0 = ops.LAUNCHES["flash_fwd"]
    got = ops.flash_fwd_op(q, k, v, causal=causal, window=win, q_offset=off)
    want = ref.flash_fwd_ref(q, k, v, causal=causal, window=win, q_offset=off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_fwd"] == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulp(want) + 1e-6
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(gpu, B, S, H, hd, N, chunk):
    rng = np.random.default_rng(S + H)

    def r(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device=gpu)
    dt = torch.nn.functional.softplus(r(B, S, H))
    x = (r(B, S, H, hd, scale=0.5) * dt[..., None]).contiguous()
    dA = (dt * -torch.exp(r(H, scale=0.3))).contiguous()
    Bm, Cm = r(B, S, N, scale=0.4), r(B, S, N, scale=0.4)
    n0 = ops.LAUNCHES["ssd_fwd"]
    y, st = ops.ssd_fwd_op(x, dA, Bm, Cm, chunk=chunk)
    y_p, st_p = ref.ssd_fwd_ref(x, dA, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_fwd"] == n0 + 1
    torch.testing.assert_close(y, y_p, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(st, st_p, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(gpu):
    q = torch.zeros((1, 8, 4, 48), device=gpu)          # hd 48: not built
    with pytest.raises(ValueError, match="hd in"):
        ops.flash_fwd_op(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    x = torch.zeros((1, 20, 2, 8), device=gpu)
    with pytest.raises(ValueError, match="S % Q"):
        ops.ssd_fwd_op(x, torch.zeros((1, 20, 2), device=gpu),
                       torch.zeros((1, 20, 4), device=gpu),
                       torch.zeros((1, 20, 4), device=gpu), chunk=16)
