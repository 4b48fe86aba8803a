"""The models' prefill kernels, the COO scatter-add, the Zen encode,
commit push and pull decode, the hash stage, the row compaction and the
bitmap pack and unpack against their plain versions, on the card, and the
plain scatter-add on the card against its own CPU run.

Imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_gpu.py

Every case is marked ``cuda`` and skips without a CUDA GPU (the kernels
have no CPU mode; their plain versions are held against the reference by
``tests/test_torch_flash.py`` and ``tests/test_torch_ssd.py``).
Tolerances: ``flash_fwd`` (k = v at hd 32 / 64 / 128 / 160, and MLA's
q/k 96 with v 64) in f32 to 2e-5 and in bf16 to one bf16 ulp (plus 1e-6
near zero); an unsupported (hd, hd_v) pair raises; ``ssd_fwd`` to 2e-4
(atol and rtol) -- both sum in another order than their plain versions;
``coo_scatter_add`` and the push bitwise (they keep the stream order of
every target's adds);
``zen_encode``, the pull, the hash stage, the row compaction and the
bitmap pair bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hashing import hash_u32
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
    # the wide head dims (dynamic shared memory; the f32 rows split over
    # four lanes)
    (1, 256, 256, 16, 2, 128, True, 0, 0),     # g = 8, as qwen2.5-3b
    (2, 130, 130, 8, 8, 128, True, 0, 0),      # KV = H, ragged Sq
    (1, 200, 200, 16, 2, 128, True, 64, 0),    # window
    (1, 65, 127, 4, 2, 128, True, 0, 62),      # q_offset
    (1, 256, 256, 32, 8, 160, True, 0, 0),     # g = 4, as pixtral-12b
    (2, 100, 100, 8, 2, 160, True, 0, 0),      # ragged Sq
    (1, 150, 150, 6, 2, 160, False, 32, 0),    # window, non-causal
    # whisper-medium: cross prefill (Sq != Sk, Sk = 1500: a last tile of
    # 28 keys), cross decode (Sq = 1), the encoder (1500 x 1500, no mask);
    # pixtral-12b's prefill (256 patches + 512 tokens, hd 160)
    (1, 512, 1500, 16, 16, 64, False, 0, 0),
    (8, 1, 1500, 16, 16, 64, False, 0, 0),
    (1, 1500, 1500, 16, 16, 64, False, 0, 0),
    (1, 768, 768, 32, 8, 160, True, 0, 0),
    # MLA (minicpm3): q/k 96, v 64 (hd is the pair): its prefill at B 1,
    # ragged Sq, a window, a q_offset, and GQA without a mask
    (1, 512, 512, 40, 40, (96, 64), True, 0, 0),
    (2, 130, 130, 8, 8, (96, 64), True, 0, 0),
    (1, 200, 200, 8, 8, (96, 64), True, 64, 0),
    (1, 65, 127, 4, 4, (96, 64), True, 0, 62),
    (1, 100, 300, 4, 2, (96, 64), False, 0, 0),
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
# the encode's cases: one partition far over C / n that overflows r2, r2 = 4,
# EMPTY entries inside the stream, no candidate at all, lists too long for
# shared memory, indices that start off a 16-byte boundary, and the
# EF-compressed buckets' rows at n = 8 and topk:0.01: a per-leaf ffn
# leaf's (r1 + r2 = 47,941, the row in shared memory, the lists not) and a
# 25 MiB bucket's (143,820: the row and ballots in global scratch)
ENCODE_CASES = ["skew", "r2=4", "empty-middle", "all-empty", "scratch",
                "unaligned", "row-47941", "row-143820"]
# EF-compressed buckets at n = 8, topk:0.01 (layout budget 0.04): elements
# S, and the layout's C, r1, r2 and cap_server
COMPRESSED = {"row-47941": (4_358_144, 174_326, 43_582, 4_359, 544_768),
              "row-143820": (13_074_432, 522_978, 130_745, 13_075,
                             1_634_304)}
# the push's cases: 1-D values (d = 1), a d that 16 bytes does not divide,
# the slice's d, cap_pull below the kept slots, EMPTY / negative /
# out-of-range positions, and slots whose rows cancel to +0.0 or are -0.0
# and the element-sparse streams of EF-compressed buckets, whose servers
# are past the bitmap prefix's shared memory (cap_server 544,768 and
# 1,634,304, d = 1)
PUSH_CASES = ["d=1", "d=3", "d=896", "overflow", "junk", "cancel",
              "row-47941", "row-143820"]
# the pull's cases: random rows at the slice's cap_server (not a multiple
# of 32), all-ones and all-zero rows, cap_pull below a row's popcount, and
# more words than a block's threads
# and a 25 MiB EF-compressed bucket's rows (W = 51,072 words, more than the
# SMs' blocks cover, so one cooperative launch)
PULL_CASES = ["random", "ones-zeros", "small-cap", "wide", "row-143820"]
# the row compaction's cases: the slice's [n, r1 + r2] = [8, 10446], whose
# odd rows start 8 bytes into a 16-byte group, at the realistic and the
# dense stream's row densities; short rows; rows past one tile a block
# (8 x 1536 slots); one row; all-EMPTY, all-live and live-only-at-the-end
# rows; an input that starts off a 16-byte boundary
COMPACT_CASES = ["slice", "slice-dense", "L=1", "L=3", "L=129", "L=16385",
                 "L=40000", "R=1", "empty-live-end", "unaligned"]
# the hash stage's cases: C from 0 to the slice's 37984 and one past a
# multiple of four (scalar stores, a ragged last group); k = 1 and the most
# seeds the kernel takes (k = 15); n = r1 = 1; all EMPTY; seeds with the
# top bit set; indices that start off a 16-byte boundary
HASH_CASES = ["C=0", "C=1", "C=3", "C=37", "slice", "C=37987", "k=1", "k=15",
              "n=r1=1", "all-empty", "top-bit-seeds", "unaligned"]
# the bitmap pair's cases: one row (the 1-D forms) and the slice's n = 8;
# rows of 0 to 33 bits and the slice's cap_pull and cap_server (neither a
# multiple of 4, so rows start off a 4-byte boundary); all-zero, all-one
# and random masks and words
BITMAP_L = [0, 1, 31, 32, 33, 10446, 19107]
BITMAP_FILLS = ["zeros", "ones", "random"]


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
    hd, hd_v = (hd, hd) if isinstance(hd, int) else hd
    q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32),
                               device=gpu).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd_v)))
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


def _encode_case(case: str):
    """(indices int32 [C], seeds, n, r1, r2) of one encode case, from
    numpy: unique indices, EMPTY-padded."""
    rng = np.random.default_rng(len(case) + 3)
    seeds = [int(x) for x in rng.integers(0, 2**32, size=4, dtype=np.uint64)]
    n, r1, r2 = 4, 256, 64
    if case == "scratch":        # ~12000 candidates a partition: global list
        n, r1, r2 = 2, 4096, 256
        idx = rng.choice(1 << 20, 24000, replace=False)
    elif case in COMPRESSED:     # a topk:0.01 payload's ascending ids
        S, C, r1, r2, _ = COMPRESSED[case]
        n, k = 8, -(-S // 100)
        idx = np.concatenate([np.sort(rng.choice(S, k, replace=False)),
                              np.full(C - k - 37, EMPTY)])
    else:
        idx = rng.choice(1 << 16, 3000, replace=False)
        if case == "skew":       # partition 0 takes 2/3 of the stream
            part = (hash_u32(torch.as_tensor(idx), seeds[0]) % n).numpy()
            keep = (part == 0) | (rng.random(idx.size) < 0.2)
            idx = idx[keep]
            r2 = 16
        elif case in ("r2=4", "unaligned"):
            r2 = 4
        elif case == "empty-middle":   # EMPTY entries inside the stream
            idx = idx.astype(np.int64)
            idx[rng.random(idx.size) < 0.3] = EMPTY
        elif case == "all-empty":
            idx = np.full(512, EMPTY)
    idx = np.concatenate([idx, np.full(37, EMPTY)])   # EMPTY-padded tail
    return torch.as_tensor(idx, dtype=torch.int32), seeds, n, r1, r2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ENCODE_CASES)
def test_encode_kernel_is_bitwise_plain(gpu, case):
    """Each case twice in a row (the kernel keeps a finish counter between
    calls), bitwise against the plain version run on the CPU."""
    idx, seeds, n, r1, r2 = _encode_case(case)
    want = ref.zen_encode_ref(idx, seeds, n, r1, r2)
    if case in ("skew", "r2=4", "scratch"):
        assert int(want[2]) > 0, "case no longer overflows"
    dev_idx = idx.to(gpu)
    if case == "unaligned":      # a view 4 bytes into its storage
        dev_idx = torch.cat([idx[:1], idx]).to(gpu)[1:]
        assert dev_idx.data_ptr() % 16
    for _ in range(2):
        n0 = ops.LAUNCHES["zen_encode"]
        got = ops.zen_encode_fused_op(dev_idx, seeds, n, r1, r2)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["zen_encode"] == n0 + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(gpu):
    q = torch.zeros((1, 8, 4, 48), device=gpu)          # hd 48: not built
    with pytest.raises(ValueError, match="hd in"):
        ops.flash_fwd_op(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    for hd, hd_v in ((96, 96), (64, 32), (96, 32), (128, 64)):  # no kernel
        for dt in (torch.float32, torch.bfloat16):
            qk = torch.zeros((1, 8, 4, hd), device=gpu, dtype=dt)
            with pytest.raises(ValueError, match="hd_v"):
                ops.flash_fwd_op(qk, qk, torch.zeros((1, 8, 4, hd_v),
                                                     device=gpu, dtype=dt))
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
    with pytest.raises(ValueError, match="torch.bool"):  # an int mask
        ops.bitmap_pack_rows_op(torch.ones((2, 40), dtype=torch.int32,
                                           device=gpu))
    with pytest.raises(ValueError, match="2-D"):
        ops.bitmap_pack_rows_op(torch.ones((40,), dtype=torch.bool,
                                           device=gpu))
    words = torch.zeros((2, 4), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="torch.int32"):
        ops.bitmap_unpack_rows_op(words.long(), 40)
    with pytest.raises(ValueError, match="length"):      # past 32 W bits
        ops.bitmap_unpack_rows_op(words, 129)
    with pytest.raises(ValueError, match="words"):
        ops.bitmap_unpack_rows_op(words[0], 40)


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
        d = {"junk": 896, "d=1": 1, "d=3": 3, "d=100": 100}[case]
    out = rng.standard_normal((M, d)) * (rng.random((M, 1)) < 0.5)
    vals = rng.standard_normal((C, d))
    return (torch.as_tensor(out, device=dev).to(dtype),
            torch.as_tensor(idx, dtype=torch.int32, device=dev),
            torch.as_tensor(vals, device=dev).to(dtype))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _plain_scatter(out, idx, vals):
    """The plain version run on the CPU, which
    ``test_plain_scatter_add_on_the_card_is_its_cpu_run`` holds the card's
    run of it to."""
    return ref.coo_scatter_add_ref(out.cpu(), idx.cpu(), vals.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SCATTER_CASES + ["d=3"])
def test_plain_scatter_add_on_the_card_is_its_cpu_run(gpu, dtype, case):
    """The plain version writes only its targets on the card too: bitwise
    its CPU run, and the untouched -0.0 rows stay -0.0 (CUDA's bf16
    ``index_add_`` at odd d adds +0.0 to the row beside a target)."""
    out, idx, vals = _scatter_case(case, dtype, gpu)
    out[1::3] = -0.0
    want = _plain_scatter(out, idx, vals)
    got = ref.coo_scatter_add_ref(out, idx, vals)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got.cpu()), _bits(want))
    live = idx[(idx >= 0) & (idx < out.shape[0])].long().cpu()
    untouched = torch.ones(out.shape[0], dtype=torch.bool)
    untouched[live] = False
    neg0 = _bits(torch.full((1,), -0.0, dtype=dtype))
    rows = untouched & (torch.arange(out.shape[0]) % 3 == 1)
    assert rows.any() or case == "distinct"     # distinct touches every row
    assert bool((_bits(got.cpu()[rows]) == neg0).all())


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


def _push_case(case: str, dtype, dev):
    """(lp, vals, cap_server, cap_pull) of one push case, from numpy;
    vals is 1-D at d = 1."""
    rng = np.random.default_rng(len(case) + 5)
    M, L, C, d = 3000, 2500, 6000, 896
    if case in COMPRESSED:       # 8 workers' rows for one server, d = 1
        _, _, r1, r2, M = COMPRESSED[case]
        L, C, d = r1 + r2, 8 * (r1 + r2), 1
    d = {"d=1": 1, "d=3": 3}.get(case, d)
    if case == "overflow":
        L = 97
    lp = rng.integers(0, M, C)
    lp[rng.random(C) < 0.5] = M                 # dead rows, as the trainer's
    if case == "junk":
        junk = rng.random(C) < 0.1
        lp[junk] = rng.choice([EMPTY, -1, -7, M, M + 5], junk.sum())
    vals = rng.standard_normal((C, d))
    if case == "cancel":      # integers: v + (-v) is exactly +0.0
        vals = np.round(vals * 8)
        rows = {}
        for r in np.flatnonzero(lp < M):
            rows.setdefault(int(lp[r]), []).append(int(r))
        multi = [t for t, rs in sorted(rows.items()) if len(rs) >= 2]
        for t in multi[::2]:
            first, second, *rest = rows[t]
            vals[second] = -vals[first]
            vals[rest] = 0.0
        vals[rows[multi[1]]] = -0.0
    v = torch.as_tensor(vals[:, 0] if d == 1 else vals, device=dev).to(dtype)
    return torch.as_tensor(lp, dtype=torch.int32, device=dev), v, M, L


def _same_bits(got, want) -> bool:
    return all(g.dtype == w.dtype and g.shape == w.shape
               and torch.equal(_bits(g.cpu()) if g.is_floating_point()
                               else g.cpu(),
                               _bits(w) if w.is_floating_point() else w)
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PUSH_CASES)
def test_push_kernel_is_bitwise_plain(gpu, dtype, case):
    lp, vals, M, L = _push_case(case, dtype, gpu)
    want = ref.zen_commit_push_ref(lp.cpu(), vals.cpu(), M, L)
    if case == "overflow":
        assert int(want[3]) > 0, "case no longer overflows"
    n0 = ops.LAUNCHES["zen_commit_push"]
    got = ops.zen_commit_push_fused_op(lp, vals, cap_server=M, cap_pull=L)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["zen_commit_push"] == n0 + 1
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_push_kernel_leaves_its_scratch_clean(gpu, dtype):
    """Calls in a row share the kept scratch: each is still bitwise, the
    same stream twice, then smaller streams and other widths."""
    for case in ("d=896", "d=896", "junk", "d=1", "cancel", "overflow"):
        lp, vals, M, L = _push_case(case, dtype, gpu)
        if case == "d=1":                       # a smaller stream and server
            lp = torch.where(lp[:700] < 500, lp[:700], 500).contiguous()
            vals, M, L = vals[:700].contiguous(), 500, 200
        want = ref.zen_commit_push_ref(lp.cpu(), vals.cpu(), M, L)
        got = ops.zen_commit_push_fused_op(lp, vals, cap_server=M, cap_pull=L)
        assert _same_bits(got, want), case


def _pull_case(case: str):
    """(words int32 [n, W], cap_server, cap_pull) of one pull case."""
    rng = np.random.default_rng(len(case) + 7)
    n, cap_server, cap_pull = 8, 19107, 10446
    if case == "wide":                          # W = 1563 > 1024 threads
        cap_server, cap_pull = 50000, 15000
    elif case in COMPRESSED:                    # W = 51,072
        _, _, r1, r2, cap_server = COMPRESSED[case]
        cap_pull = r1 + r2
    W = -(-cap_server // 32)
    words = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64)
    words &= rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64)
    if case in COMPRESSED:   # 1 bit in 8 set in row 0 (past cap_pull), 1
        # in 16 in the others (their EMPTY tails)
        words &= rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64)
        words[1:] &= rng.integers(0, 1 << 32, size=(n - 1, W),
                                  dtype=np.uint64)
    if case == "ones-zeros":
        words[0] = words[3] = (1 << 32) - 1      # popcount > cap_pull
        words[1] = words[5] = 0
    elif case == "small-cap":
        cap_pull = 50
    return (torch.as_tensor(words.astype(np.uint32).view(np.int32)),
            cap_server, cap_pull)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PULL_CASES)
def test_pull_kernel_is_bitwise_plain(gpu, case):
    words, cap_server, cap_pull = _pull_case(case)
    want = ref.zen_commit_pull_ref(words, cap_server, cap_pull)
    n0 = ops.LAUNCHES["zen_commit_pull"]
    got = ops.zen_commit_pull_fused_op(words.to(gpu), cap_server, cap_pull)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["zen_commit_pull"] == n0 + 1
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _compact_case(case: str):
    """(mem int32 [R, L] on the CPU, whether to pass it 4 bytes off a
    16-byte boundary) of one row-compaction case, from numpy: unique live
    entries, EMPTY elsewhere."""
    rng = np.random.default_rng(len(case) + 11)
    R, L = 8, 10446
    density = {"slice-dense": 0.36, "L=16385": 0.3, "L=40000": 0.3}.get(
        case, 0.5)
    if case in ("slice", "R=1"):
        density = 0.003                     # ~28 live entries a row
    if case.startswith("L="):
        L = int(case[2:])
    if case == "R=1":
        R = 1
    mem = rng.choice(1 << 30, R * L, replace=False).reshape(R, L)
    mem[rng.random((R, L)) >= density] = EMPTY
    if case == "empty-live-end":
        R = 4
        mem = mem[:R]
        mem[0] = EMPTY                      # all EMPTY
        mem[1] = rng.choice(1 << 30, L, replace=False)   # all live
        mem[2] = EMPTY                      # live only at the end
        mem[2, -9:] = rng.choice(1 << 30, 9, replace=False)
    return torch.as_tensor(mem, dtype=torch.int32), case == "unaligned"


@pytest.mark.cuda
@pytest.mark.parametrize("case", COMPACT_CASES)
def test_row_compact_kernel_is_bitwise_plain(gpu, case):
    mem, unaligned = _compact_case(case)
    want = ref.row_compact_ref(mem)
    dev_mem = mem.to(gpu)
    if unaligned:                # a view 4 bytes into its storage
        flat = torch.cat([mem.new_zeros(1), mem.reshape(-1)]).to(gpu)
        dev_mem = flat[1:].view(mem.shape)
        assert dev_mem.data_ptr() % 16
    n0 = ops.LAUNCHES["row_compact"]
    got = ops.row_compact_op(dev_mem)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["row_compact"] == n0 + 1
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _hash_case(case: str):
    """(indices int32 [C] on the CPU, seeds, n, r1, whether to pass the
    indices 4 bytes off a 16-byte boundary) of one hash-stage case: unique
    ids with EMPTY among them; the slice's stream has its 227 live ids at
    the front, as the compaction leaves them."""
    rng = np.random.default_rng(len(case) + 5)
    C, k, n, r1 = 37987, 3, 8, 9496
    if case.startswith("C="):
        C = int(case[2:])
    elif case == "slice":
        C = 37984
    elif case.startswith("k="):
        k = int(case[2:])
    elif case == "n=r1=1":
        n = r1 = 1
    lo = 2**31 if case == "top-bit-seeds" else 0
    seeds = [int(x) for x in rng.integers(lo, 2**32, size=k + 1,
                                          dtype=np.uint64)]
    idx = rng.choice(1 << 28, C, replace=False)
    if case == "slice":
        idx[227:] = EMPTY
    elif case == "all-empty":
        idx[:] = EMPTY
    else:
        idx[rng.random(C) < 0.3] = EMPTY
    return (torch.as_tensor(idx, dtype=torch.int32), seeds, n, r1,
            case == "unaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_stage_kernel_is_bitwise_plain(gpu, case):
    idx, seeds, n, r1, unaligned = _hash_case(case)
    want = ref.hash_stage_ref(idx, seeds, n, r1)
    dev_idx = idx.to(gpu)
    if unaligned:                # a view 4 bytes into its storage
        dev_idx = torch.cat([idx[:1], idx]).to(gpu)[1:]
        assert dev_idx.data_ptr() % 16
    n0 = ops.LAUNCHES["hash_stage"]
    got = ops.hash_stage_op(dev_idx, seeds, n, r1)
    torch.cuda.synchronize()
    # an empty index vector launches nothing
    assert ops.LAUNCHES["hash_stage"] == n0 + (idx.numel() > 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


def _bitmap_fill(rng, shape, fill: str, dtype):
    """zeros, ones (every bit set) or random bits of ``shape``: bool for a
    mask, int32 for words."""
    if dtype == torch.bool:
        x = {"zeros": np.zeros(shape, bool), "ones": np.ones(shape, bool),
             "random": rng.random(shape) < 0.4}[fill]
        return torch.as_tensor(x)
    x = {"zeros": np.zeros(shape, np.uint32),
         "ones": np.full(shape, 0xFFFFFFFF, np.uint32),
         "random": rng.integers(0, 1 << 32, shape, dtype=np.uint64)
         .astype(np.uint32)}[fill]
    return torch.as_tensor(x.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", BITMAP_FILLS)
@pytest.mark.parametrize("L", BITMAP_L)
@pytest.mark.parametrize("n", [1, 8])
def test_bitmap_pack_kernel_is_bitwise_plain(gpu, n, L, fill):
    mask = _bitmap_fill(np.random.default_rng(L + n), (n, L), fill,
                        torch.bool)
    want = ref.bitmap_pack_rows_ref(mask)
    n0 = ops.LAUNCHES["bitmap_pack"]
    got = ops.bitmap_pack_rows_op(mask.to(gpu))
    torch.cuda.synchronize()
    # empty rows launch nothing
    assert ops.LAUNCHES["bitmap_pack"] == n0 + (L > 0)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    # the same rows one byte into their storage
    off = torch.cat([mask.new_zeros(1), mask.reshape(-1)]).to(gpu)[1:]
    assert torch.equal(ops.bitmap_pack_rows_op(off.view(n, L)).cpu(), want)
    if n == 1:
        assert torch.equal(ops.bitmap_pack_op(mask[0].to(gpu)).cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fill", BITMAP_FILLS)
@pytest.mark.parametrize("L", BITMAP_L)
@pytest.mark.parametrize("n", [1, 8])
def test_bitmap_unpack_kernel_is_bitwise_plain(gpu, n, L, fill):
    W = -(-L // 32) + 1                     # L below 32 W
    words = _bitmap_fill(np.random.default_rng(L + n), (n, W), fill,
                         torch.int32)
    for length in (L, 32 * W):
        want = ref.bitmap_unpack_rows_ref(words, length)
        n0 = ops.LAUNCHES["bitmap_unpack"]
        got = ops.bitmap_unpack_rows_op(words.to(gpu), length)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["bitmap_unpack"] == n0 + (length > 0)
        assert got.dtype == want.dtype and got.is_contiguous()
        assert torch.equal(got.cpu(), want)
        if n == 1:
            assert torch.equal(
                ops.bitmap_unpack_op(words[0].to(gpu), length).cpu(), want[0])
