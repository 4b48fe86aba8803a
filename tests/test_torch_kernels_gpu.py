"""The models' prefill kernels and the COO scatter-add against their plain
versions, on the card.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_gpu.py

Every case is marked ``cuda`` and skips without a CUDA GPU (the kernels
have no CPU mode; their plain versions are held against the reference by
``tests/test_torch_flash.py`` and ``tests/test_torch_ssd.py``).
Tolerances: ``flash_fwd`` in f32 to 2e-5 and in bf16 to one bf16 ulp (plus
1e-6 near zero); ``ssd_fwd`` to 2e-4 (atol and rtol) -- both sum in
another order than their plain versions; ``coo_scatter_add`` bitwise (it
keeps the stream order of every target's adds).
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
    # the tensor-core kernel's edges: Q not a multiple of 16 (zero-padded
    # query tiles), hd 32 with N 128 (four warps a state row), the serve
    # shape's widths
    (1, 60, 2, 32, 128, 20), (2, 40, 3, 64, 32, 40), (1, 512, 4, 64, 128, 64),
]
EMPTY = 2**31 - 1
# the scatter-add's cases: M rows of out, d columns, the index stream
SCATTER_CASES = ["repeat4096", "distinct", "junk", "d=1", "d=100"]


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
    with pytest.raises(ValueError, match="hd in"):      # hd 48: not built
        ops.ssd_fwd_op(torch.zeros((1, 16, 2, 48), device=gpu),
                       torch.zeros((1, 16, 2), device=gpu),
                       torch.zeros((1, 16, 16), device=gpu),
                       torch.zeros((1, 16, 16), device=gpu), chunk=16)


def _scatter_case(case: str, dtype, dev):
    """(out, idx, vals) of one scatter-add case, from numpy."""
    rng = np.random.default_rng(len(case))
    M, d, C = 3000, 896, 6000
    if case == "repeat4096":      # one target repeated 4096 times
        idx = rng.integers(0, M, C)
        idx[rng.choice(C, 4096, replace=False)] = 7
    elif case == "distinct":      # every row a distinct target: T = C
        C = M
        idx = rng.permutation(M)
    else:                         # duplicates, EMPTY, negative, >= M
        idx = rng.integers(0, M, C)
        junk = rng.random(C) < 0.1
        idx[junk] = rng.choice([EMPTY, -1, -7, M, M + 5], junk.sum())
        d = {"junk": 896, "d=1": 1, "d=100": 100}[case]
    out = rng.standard_normal((M, d)) * (rng.random((M, 1)) < 0.5)
    vals = rng.standard_normal((C, d))
    return (torch.as_tensor(out, device=dev).to(dtype),
            torch.as_tensor(idx, dtype=torch.int32, device=dev),
            torch.as_tensor(vals, device=dev).to(dtype))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _plain_scatter(out, idx, vals):
    """The plain version on the CPU.  On the card its bf16 ``index_add_``
    adds through 32-bit words, so at d = 1 it also adds +0.0 to the row
    beside each target, turning an untouched -0.0 into +0.0; the kernel
    leaves untouched rows alone, as the function says."""
    return ref.coo_scatter_add_ref(out.cpu(), idx.cpu(), vals.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_add_kernel_is_bitwise_plain(gpu, dtype, case):
    out, idx, vals = _scatter_case(case, dtype, gpu)
    want = _plain_scatter(out, idx, vals)
    n0 = ops.LAUNCHES["coo_scatter_add"]
    got = ops.coo_scatter_add_op(out.clone(), idx, vals)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["coo_scatter_add"] == n0 + 1
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_leaves_its_scratch_clean(gpu, dtype):
    """Calls in a row share the kept scratch: each is still bitwise, with
    the scratch grown between them and reused at a smaller size."""
    for case in ("junk", "repeat4096", "junk", "distinct", "d=1", "junk"):
        out, idx, vals = _scatter_case(case, dtype, gpu)
        if case == "distinct":          # more rows than any call before
            out = torch.cat([out, out, out]).contiguous()
        want = _plain_scatter(out, idx, vals)
        got = ops.coo_scatter_add_op(out.clone(), idx, vals)
        assert torch.equal(_bits(got.cpu()), _bits(want)), case
