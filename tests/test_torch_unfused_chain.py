"""Port parity for Zen's unfused dispatch chain (``fused_encode=False``,
``fused_commit=False``): the plain versions of its five kernels (hash
stage, row compaction, bitmap pack / unpack in their 1-D and row forms,
COO scatter-add), the three
pre-fusion compositions, the hashing routes and the trainer's
``--no-fused-commit``, each on the same numpy inputs as the JAX reference.
``zen_sync`` and ``GradSync`` on the unfused routes are in
tests/test_torch_zen_sync.py.

The reference's interpret-mode hash-stage, row-compaction and bitmap
kernels and its unfused encode run on the CPU; its Pallas scatter-add does
not (``pl.load`` is gone from this JAX), so the aggregation is held against
``ref.coo_scatter_add_ref`` and ``batched_coo_reduce_op(backend="xla")``,
and the unfused push against the reference's fused push, which the
reference's own contract makes bitwise equal to it.  On the CPU the port's
``kernels/ops.py`` wrappers take the plain versions; the CUDA kernels are
held against those on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import formats as F
from repro.core import schemes as S
from repro.core.hashing import EMPTY, compact_indices
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro_torch.configs import get_config
from repro_torch.core import formats as tformats
from repro_torch.core import hashing as thashing
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    """A reference output as the port holds it: uint32 words -> int32
    bits, bf16 -> f32 (exact)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def _port(x: torch.Tensor) -> np.ndarray:
    x = torch.as_tensor(x)
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_port(g), _np(w),
                                      err_msg=f"{what}: output {i}")


def _seeds(k: int = 3) -> list[int]:
    lo = S.make_zen_layout(1024, 4, density_budget=0.1, key=0, k=k)
    return [int(s) for s in lo.seeds]


def _indices(C, live, M, seed):
    """EMPTY-padded unique indices [C] with ``live`` of them set."""
    rng = np.random.default_rng(seed)
    idx = np.full(C, EMPTY, dtype=np.int32)
    idx[:live] = rng.choice(M, size=live, replace=False)
    return idx


# ---------------------------------------------------------------------------
# the five kernels' plain versions
# ---------------------------------------------------------------------------

HASH_CASES = [  # C, live, n, r1, k
    (1000, 700, 4, 300, 3),    # C not a multiple of the reference's tiles
    (37, 37, 8, 11, 3),
    (1 << 12, 100, 8, 97, 3),  # mostly EMPTY
    # the card kernel's edges: C % 4 != 0 (scalar stores, a ragged last
    # group of four), a group of one live index and three EMPTY ones, the
    # most seeds it takes (k = 15)
    (37987, 20001, 8, 9496, 15),
]


@pytest.mark.parametrize("C,live,n,r1,k", HASH_CASES, ids=[
    f"{C}-{live}-{n}-{r1}" + (f"-k{k}" if k != 3 else "")
    for C, live, n, r1, k in HASH_CASES])
def test_hash_stage_plain_matches_reference(C, live, n, r1, k):
    idx = _indices(C, live, 1 << 20, C)
    seeds = _seeds(k)
    want_kern = kops.hash_stage_op(jnp.asarray(idx), seeds, n, r1)
    want_ref = kref.hash_stage_ref(jnp.asarray(idx),
                                   jnp.asarray(seeds, dtype=jnp.uint32), n, r1)
    got = tref.hash_stage_ref(_t(idx), seeds, n, r1)
    _assert_equal(got, want_kern, "plain vs interpret-mode kernel")
    _assert_equal(got, want_ref, "plain vs reference ref")
    assert int((got[0] == n).sum()) == C - live     # EMPTY -> sentinels
    assert bool((got[1][:, live:] == r1).all())
    _assert_equal(tops.hash_stage_op(_t(idx), seeds, n, r1), want_kern,
                  "ops wrapper on a CPU tensor")


@pytest.mark.parametrize("R,L,density", [
    (4, 300, 0.5), (8, 129, 0.05), (3, 1000, 0.95),
    # the card kernel's edges: the slice's [n, r1 + r2] (odd rows start 8
    # bytes into a 16-byte group) at the realistic stream's ~28 live
    # entries a row, and rows past one tile a block (8 x 1536 slots)
    (8, 10446, 0.003), (2, 16385, 0.3)])
def test_row_compact_plain_matches_reference(R, L, density):
    rng = np.random.default_rng(L)
    mem = rng.integers(0, 1 << 30, size=(R, L)).astype(np.int32)
    mem[rng.random((R, L)) >= density] = EMPTY
    want_kern = kops.row_compact_op(jnp.asarray(mem))
    want_ref = kref.row_compact_ref(jnp.asarray(mem))
    got = tref.row_compact_ref(_t(mem))
    _assert_equal([got], [want_kern], "plain vs interpret-mode kernel")
    _assert_equal([got], [want_ref], "plain vs reference ref")
    _assert_equal([tops.row_compact_op(_t(mem))], [want_kern],
                  "ops wrapper on a CPU tensor")


@pytest.mark.parametrize("M", [1, 31, 33, 1000, 4097])
def test_bitmap_pack_unpack_plain_match_reference(M):
    rng = np.random.default_rng(M)
    mask = rng.random(M) < 0.4
    W = -(-M // 32)
    bits = np.zeros(W * 32, dtype=np.int32)
    bits[:M] = mask
    want = kops.bitmap_pack_op(jnp.asarray(mask))
    _assert_equal([tops.bitmap_pack_op(_t(mask))], [want],
                  "pack wrapper vs interpret-mode kernel")
    _assert_equal([tref.bitmap_pack_ref(_t(bits))],
                  [kref.bitmap_pack_ref(jnp.asarray(bits))], "pack plain")
    words = rng.integers(0, 1 << 32, size=W, dtype=np.uint64).astype(np.uint32)
    tw = _t(words.view(np.int32))
    _assert_equal([tref.bitmap_unpack_ref(tw)],
                  [kref.bitmap_unpack_ref(jnp.asarray(words))], "unpack plain")
    _assert_equal([tops.bitmap_unpack_op(tw, M)],
                  [kops.bitmap_unpack_op(jnp.asarray(words), M)],
                  "unpack wrapper vs interpret-mode kernel")
    # words <-> bits round trip through the formats routes
    for backend in ("torch", "cuda"):
        enc = tformats.bitmap_encode(_t(mask), backend=backend)
        np.testing.assert_array_equal(
            tformats.bitmap_decode(enc, M, backend=backend).numpy(), mask)


BITMAP_ROWS = [  # n, L: ragged L, the slice's cap_pull and cap_server
    (1, 1), (3, 31), (2, 32), (8, 33), (4, 1000), (8, 10446), (8, 19107)]


@pytest.mark.parametrize("n,L", BITMAP_ROWS)
def test_bitmap_rows_plain_match_reference(n, L):
    """The row forms' plain versions (and the wrappers and formats routes
    on a CPU tensor) against the reference's interpret-mode
    ``bitmap_pack_rows_op`` and its ``bitmap_decode_batch`` on both of its
    routes; an all-zero and an all-one row among random ones."""
    rng = np.random.default_rng(n * L)
    mask = rng.random((n, L)) < 0.4
    mask[0] = False
    mask[-1] |= n > 1
    want = kops.bitmap_pack_rows_op(jnp.asarray(mask))
    _assert_equal([tref.bitmap_pack_rows_ref(_t(mask))], [want],
                  "pack rows plain vs interpret-mode kernel")
    _assert_equal([tops.bitmap_pack_rows_op(_t(mask))], [want],
                  "pack rows wrapper on a CPU tensor")
    for backend in ("torch", "cuda"):
        _assert_equal([tformats.bitmap_encode(_t(mask), backend=backend)],
                      [want], f"bitmap_encode [n, L] {backend}")
    W = -(-L // 32) + 1                     # L below 32 W
    words = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64) \
        .astype(np.uint32)
    words[0] = 0
    words[-1] = 0xFFFFFFFF if n > 1 else words[-1]
    tw = _t(words.view(np.int32))
    for backend in ("xla", "pallas"):
        want = F.bitmap_decode_batch(jnp.asarray(words), L, backend=backend)
        got = tref.bitmap_unpack_rows_ref(tw, L)
        assert got.is_contiguous()
        _assert_equal([got], [want], f"unpack rows plain vs {backend}")
        _assert_equal([tops.bitmap_unpack_rows_op(tw, L)], [want],
                      f"unpack rows wrapper on a CPU tensor vs {backend}")
        for tb in ("torch", "cuda"):
            _assert_equal([tformats.bitmap_decode_batch(tw, L, backend=tb)],
                          [want], f"bitmap_decode_batch {tb} vs {backend}")


def _scatter_inputs(rows, C, d, seed, runs):
    """A non-zero ``out``, a stream with EMPTY and >= rows entries, and
    ``runs`` long duplicate runs; values whose bf16 sums depend on the
    order of the adds."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, size=C).astype(np.int32)
    for r in range(runs):      # one target repeated 40-200 times
        sel = rng.choice(C, size=rng.integers(40, 200), replace=False)
        idx[sel] = r
    idx[rng.random(C) < 0.05] = EMPTY
    idx[rng.random(C) < 0.03] = rows + 3
    vals = (rng.standard_normal((C, d)) * 100).astype(np.float32)
    out = (rng.standard_normal((rows, d)) * 100).astype(np.float32)
    out[rng.random(rows) < 0.3] = 0
    return out, idx, vals


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,C,d,runs", [(24, 400, 3, 2), (300, 2000, 8, 5),
                                           (64, 600, 1, 1)])
def test_coo_scatter_add_plain_matches_reference(rows, C, d, runs, dtype):
    out, idx, vals = _scatter_inputs(rows, C, d, rows + C, runs)
    jd, td = DTYPES[dtype]
    jo, jv = jnp.asarray(out).astype(jd), jnp.asarray(vals).astype(jd)
    to, tv = _t(out).to(td), _t(vals).to(td)
    want = kops.batched_coo_reduce_op(jo, jnp.asarray(idx), jv, backend="xla")
    _assert_equal([tref.coo_scatter_add_ref(to, _t(idx), tv)], [want],
                  "plain into out vs reference xla route")
    zeros = kref.coo_scatter_add_ref(rows, jnp.asarray(idx), jv)
    _assert_equal([tref.coo_scatter_add_ref(rows, _t(idx), tv)], [zeros],
                  "plain into zeros vs reference ref")
    for backend in ("torch", "cuda"):   # in place, on both routes
        acc = to.clone()
        res = tops.batched_coo_reduce_op(acc, _t(idx), tv, backend=backend)
        assert res is acc
        _assert_equal([acc], [want], f"batched_coo_reduce_op {backend}")
    flat = tops.batched_coo_reduce_op(to[:, 0].clone(), _t(idx), tv[:, 0],
                                      backend="cuda")
    _assert_equal([flat], [kops.batched_coo_reduce_op(
        jo[:, 0], jnp.asarray(idx), jv[:, 0], backend="xla")], "1-D values")


def test_coo_scatter_add_drops_negative_indices():
    """Negative targets are dropped, as the reference's kernel drops them
    (its XLA route would wrap them; no caller passes one): checked against
    a sequential loop."""
    rng = np.random.default_rng(5)
    rows, C = 16, 200
    idx = rng.integers(-5, rows + 5, size=C).astype(np.int32)
    idx[::7] = EMPTY
    vals = rng.standard_normal((C, 2)).astype(np.float32)
    out = rng.standard_normal((rows, 2)).astype(np.float32)
    want = out.copy()
    for i, v in zip(idx, vals):
        if 0 <= i < rows:
            want[i] = want[i] + v
    got = tops.coo_scatter_add_op(_t(out), _t(idx), _t(vals))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the pre-fusion compositions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,r1,r2,density", [(4, 64, 4, 0.3)])
def test_encode_chain_matches_reference_chain(n, r1, r2, density):
    """``zen_encode_unfused`` (hash-stage + row-compact + pack wrappers) vs
    the reference's unfused chain in interpret mode and the fused op."""
    M = 1 << 11
    rng = np.random.default_rng(M + r2)
    mask = rng.random(M) < density
    cap = -(-max(int(M * density * 2), 64) // 128) * 128
    idx = np.asarray(compact_indices(jnp.asarray(mask), cap)[0])
    seeds = _seeds()
    want = kops.zen_encode_unfused(jnp.asarray(idx), seeds, n, r1, r2)
    fused = kops.zen_encode_fused_op(jnp.asarray(idx), seeds, n, r1, r2)
    got = tops.zen_encode_unfused(_t(idx), seeds, n, r1, r2)
    _assert_equal(got, want, "unfused chain vs reference unfused chain")
    _assert_equal(got, fused, "unfused chain vs reference fused op")
    if r2 == 4:
        assert int(got[2]) > 0, "edge case no longer overflows"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [None, 4], ids=["flat", "rows"])
def test_commit_chains_match_reference(d, dtype):
    """``zen_commit_push_unfused`` vs the reference's fused push (its
    unfused push reaches the broken Pallas scatter-add), and
    ``zen_commit_pull_unfused`` vs the reference's unfused pull."""
    rng = np.random.default_rng(3)
    cap_server, cap_pull, C = 256, 48, 512
    lp = rng.integers(0, cap_server, size=C).astype(np.int32)
    lp[rng.random(C) < 0.5] = cap_server
    lp[rng.random(C) < 0.02] = EMPTY
    vals = np.round(rng.standard_normal((C,) if d is None else (C, d)) * 8) \
        .astype(np.float32)
    jd, td = DTYPES[dtype]
    want = kops.zen_commit_push_fused_op(
        jnp.asarray(lp), jnp.asarray(vals).astype(jd), cap_server=cap_server,
        cap_pull=cap_pull)
    got = tops.zen_commit_push_unfused(_t(lp), _t(vals).to(td),
                                       cap_server=cap_server,
                                       cap_pull=cap_pull)
    _assert_equal(got, want, "unfused push vs reference push")
    assert int(got[3]) > 0, "edge case no longer overflows"
    words = np.stack([np.asarray(want[2])] * 3)
    _assert_equal([tops.zen_commit_pull_unfused(_t(words.view(np.int32)),
                                                cap_server, cap_pull)],
                  [kops.zen_commit_pull_unfused(jnp.asarray(words),
                                                cap_server, cap_pull)],
                  "unfused pull vs reference unfused pull")


# ---------------------------------------------------------------------------
# hashing routes, wrappers and the launcher (zen_sync and GradSync on the
# unfused routes: tests/test_torch_zen_sync.py, beside the fused route's
# cases whose reference programs they share)
# ---------------------------------------------------------------------------

def test_hashing_backend_routes_agree():
    """``hierarchical_hash`` / ``extract_partitions`` give the same bits on
    both routes (the cuda route takes the hash-stage / row-compaction
    wrappers), and an unknown backend is refused."""
    idx = _t(_indices(600, 500, 1 << 16, 1))
    seeds = _seeds()
    parts = [thashing.hierarchical_hash(idx, n=4, r1=150, r2=12, k=3,
                                        seeds=seeds, backend=b)
             for b in ("torch", "cuda")]
    for a, b in zip(*parts):
        assert torch.equal(a, b)
    assert torch.equal(thashing.extract_partitions(parts[0]),
                       thashing.extract_partitions(parts[1], backend="cuda"))
    with pytest.raises(ValueError, match="backend"):
        thashing.hierarchical_hash(idx, n=4, r1=150, r2=12, k=3, seeds=seeds,
                                   backend="pallas")


def test_unfused_wrappers_take_the_plain_route_on_cpu():
    """Each of the five wrappers counts one plain call for a CPU tensor and
    no launch; the fused kernels' counters stay at 0."""
    tops.reset_counts()
    idx = torch.arange(40, dtype=torch.int32)
    tops.hash_stage_op(idx, _seeds(), 4, 16)
    tops.row_compact_op(torch.full((2, 5), EMPTY, dtype=torch.int32))
    tops.bitmap_pack_op(torch.ones(40, dtype=torch.bool))
    tops.bitmap_unpack_op(torch.zeros(2, dtype=torch.int32), 40)
    tops.coo_scatter_add_op(torch.zeros(8, 2), idx[:4], torch.ones(4, 2))
    assert tops.PLAIN_CALLS == {k: int(k in tops.UNFUSED_KERNELS)
                                for k in tops.KERNELS}
    assert tops.LAUNCHES == dict.fromkeys(tops.KERNELS, 0)
    with pytest.raises(ValueError, match="length"):
        tops.bitmap_unpack_op(torch.zeros(1, dtype=torch.int32), 33)
    with pytest.raises(ValueError, match="1-D"):
        tops.bitmap_pack_op(torch.ones((2, 40), dtype=torch.bool))
    # empty rows: [n, 0] words and bits
    assert tops.bitmap_pack_rows_op(
        torch.zeros((3, 0), dtype=torch.bool)).shape == (3, 0)
    assert tops.bitmap_unpack_rows_op(
        torch.zeros((3, 0), dtype=torch.int32), 0).shape == (3, 0)


def test_trainer_no_fused_commit_on_cpu():
    """``launch/train.py --no-fused-commit --device cpu`` runs the unfused
    commit chain and gives the fused route's losses and wire words."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--mesh", "4x1", "--sync",
            "zen", "--global-batch", "4", "--seq-len", "16", "--steps", "2",
            "--log-every", "1", "--device", "cpu"]
    fused = train.main(argv)
    tops.reset_counts()
    unf = train.main(argv + ["--no-fused-commit"])
    assert unf["losses"] == fused["losses"]
    assert unf["sparse_words"] == fused["sparse_words"] > 0
    assert unf["overflow"] == 0
    per_sync = tops.path_launches(4, fused_commit=False)
    assert per_sync["bitmap_pack"] == 1   # the 4 server masks in one pack
    # and each of the 4 ranks runs each layer's attention twice a step
    L = get_config("qwen2-0.5b").reduced().n_layers
    assert tops.PLAIN_CALLS == {
        k: 2 * (per_sync.get(k, 0) + 4 * 2 * L * (k == "flash_fwd"))
        for k in tops.KERNELS}
