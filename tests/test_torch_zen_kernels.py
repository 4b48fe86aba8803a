"""Port parity: the plain versions of the three Zen CUDA kernels, bitwise
against the reference's kernel dispatch (``repro.kernels.ops.*_fused_op``)
and against its Pallas kernels in interpret mode (``force_kernel=True``),
including the overflow edges.

On the CPU the port's ``kernels/ops.py`` wrappers take the plain versions
(``kernels/ref.py``); the CUDA kernels themselves are held against those
plain versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import schemes as S
from repro.core.hashing import EMPTY, compact_indices
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


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
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_port(torch.as_tensor(g)), _np(w),
                                      err_msg=f"{what}: output {i}")


def _seeds() -> list[int]:
    lo = S.make_zen_layout(1024, 4, density_budget=0.1, key=0)
    return [int(s) for s in lo.seeds]


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,n,r1,r2,density", [
    (1 << 12, 4, 512, 64, 0.01),
    (1 << 12, 8, 128, 16, 0.1),
    (1 << 11, 4, 64, 4, 0.3),       # serial-memory overflow edge
])
def test_encode_plain_matches_reference_routes(M, n, r1, r2, density):
    rng = np.random.default_rng(M + n)
    mask = rng.random(M) < density
    cap = -(-max(int(M * density * 2), 64) // 128) * 128
    idx = np.asarray(compact_indices(jnp.asarray(mask), cap)[0])
    seeds = _seeds()
    fused = kops.zen_encode_fused_op(jnp.asarray(idx), seeds, n, r1, r2)
    kern = kops.zen_encode_fused_op(jnp.asarray(idx), seeds, n, r1, r2,
                                    force_kernel=True)
    got = tref.zen_encode_ref(_t(idx), seeds, n, r1, r2)
    _assert_equal(got, fused, "plain vs reference fused op")
    _assert_equal(got, kern, "plain vs reference interpret-mode kernel")
    via_ops = tops.zen_encode_fused_op(_t(idx), seeds, n, r1, r2)
    _assert_equal(via_ops, fused, "ops wrapper on a CPU tensor")
    if r2 == 4:
        assert int(got[2]) > 0, "edge case no longer overflows"


# ---------------------------------------------------------------------------
# commit push
# ---------------------------------------------------------------------------

def _push_inputs(cap_server, C, density, d, seed=0):
    """Post-all_to_all commit input: positions in [0, cap_server) with
    dead rows at cap_server (EMPTY-mapped), integer-valued values so bf16
    sums are exact; positions repeat across the stream."""
    rng = np.random.default_rng(seed)
    lp = rng.integers(0, cap_server, size=C).astype(np.int32)
    dead = rng.random(C) >= density
    lp[dead] = cap_server
    lp[rng.random(C) < 0.02] = EMPTY
    shape = (C,) if d is None else (C, d)
    vals = np.round(rng.standard_normal(shape) * 8).astype(np.float32)
    vals[dead] = 0
    return lp, vals


CANCEL = "cancel"   # the density of the cancellation stream's case


def _cancel_inputs(cap_server, C, d):
    """``_push_inputs`` at density 0.5, then every other slot that gets two
    or more rows has its second row the negative of its first and any
    later rows zero (an exact +0.0 sum: the values are integers), and one
    slot's rows are -0.0.  Returns (lp, vals, the slots whose sum is
    zero): occupied slots that the mask must drop."""
    lp, vals = _push_inputs(cap_server, C, 0.5, d)
    live = np.flatnonzero((lp >= 0) & (lp < cap_server))
    rows = {}
    for r in live:                              # stream order within a slot
        rows.setdefault(int(lp[r]), []).append(int(r))
    gone = [s for s, rs in sorted(rows.items()) if len(rs) >= 2][::2]
    for s in gone:
        first, second, *rest = rows[s]
        vals[second] = -vals[first]
        vals[rest] = 0.0
    neg0 = next(s for s in sorted(rows) if s not in gone)
    vals[rows[neg0]] = -0.0
    return lp, vals, gone + [neg0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [None, 4], ids=["flat", "rows"])
@pytest.mark.parametrize("cap_server,cap_pull,C,density", [
    (200, 96, 600, 0.05),
    (512, 192, 1024, 0.3),
    (256, 16, 512, 0.5),            # aggregated nnz >> pull capacity
    (256, 96, 512, CANCEL),         # occupied slots whose rows cancel
])
def test_push_plain_matches_reference_routes(cap_server, cap_pull, C,
                                             density, d, dtype):
    if density == CANCEL:
        lp, vals, gone = _cancel_inputs(cap_server, C, d)
    else:
        lp, vals = _push_inputs(cap_server, C, density, d)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jv = jnp.asarray(vals).astype(jd)
    fused = kops.zen_commit_push_fused_op(jnp.asarray(lp), jv,
                                          cap_server=cap_server,
                                          cap_pull=cap_pull)
    kern = kops.zen_commit_push_fused_op(jnp.asarray(lp), jv,
                                         cap_server=cap_server,
                                         cap_pull=cap_pull, force_kernel=True)
    got = tref.zen_commit_push_ref(_t(lp), _t(vals).to(td), cap_server,
                                   cap_pull)
    assert got[1].dtype == td
    _assert_equal(got, fused, "plain vs reference fused op")
    _assert_equal(got, kern, "plain vs reference interpret-mode kernel")
    if cap_pull == 16:
        assert int(got[3]) > 0, "edge case no longer overflows"
    if density == CANCEL:   # occupancy and mask differ: those slots drop
        bits = tref.bitmap_unpack_ref(got[2])
        assert len(gone) > 1 and not bits[gone].any()
        occupied = np.unique(lp[(lp >= 0) & (lp < cap_server)]).size
        assert int(bits.sum()) <= occupied - len(gone)


# ---------------------------------------------------------------------------
# pull decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap_server,cap_pull", [(200, 96), (1000, 64),
                                                 (64, 64), (19107, 10446)])
def test_pull_plain_matches_reference_routes(cap_server, cap_pull):
    rng = np.random.default_rng(cap_server)
    n = 4
    W = -(-cap_server // 32)
    words = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64) \
        .astype(np.uint32)
    fused = kops.zen_commit_pull_fused_op(jnp.asarray(words), cap_server,
                                          cap_pull)
    got = tref.zen_commit_pull_ref(_t(words.view(np.int32)), cap_server,
                                   cap_pull)
    _assert_equal([got], [fused], "plain vs reference fused op")
    if cap_server <= 1000:   # the interpret-mode kernel is O(W*32*cap_pull)
        kern = kops.zen_commit_pull_fused_op(jnp.asarray(words), cap_server,
                                             cap_pull, force_kernel=True)
        _assert_equal([got], [kern], "plain vs interpret-mode kernel")


def test_coo_scatter_add_keeps_stream_order():
    """Duplicates accumulate in stream order in the values' dtype: bf16
    sums that round differently in another order must still match."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 24, size=400).astype(np.int32)
    idx[rng.random(400) < 0.1] = EMPTY
    idx[:5] = 30                     # out of range: dropped
    vals = (rng.standard_normal((400, 3)) * 100).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        ref = kref.coo_scatter_add_ref(24, jnp.asarray(idx),
                                       jnp.asarray(vals).astype(jd))
        got = tref.coo_scatter_add_ref(24, _t(idx), _t(vals).to(td))
        np.testing.assert_array_equal(_port(got), _np(ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_coo_scatter_add_writes_only_its_targets(dtype):
    """At d = 1 with -0.0 in every row of ``out``: the touched rows equal
    the reference's scatter-add bitwise (non-zero values, so starting from
    -0.0 or +0.0 gives the same sums) and the untouched rows stay -0.0."""
    rng = np.random.default_rng(11)
    rows = 64
    idx = rng.integers(0, rows, size=300).astype(np.int32)
    idx[rng.random(300) < 0.1] = EMPTY
    vals = (rng.standard_normal((300, 1)) * 50).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = _np(kref.coo_scatter_add_ref(rows, jnp.asarray(idx),
                                        jnp.asarray(vals).astype(jd)))
    out = torch.full((rows, 1), -0.0, dtype=td)
    got = _port(tref.coo_scatter_add_ref(out, _t(idx), _t(vals).to(td)))
    touched = np.zeros(rows, dtype=bool)
    touched[idx[idx != EMPTY]] = True
    assert 0 < touched.sum() < rows
    np.testing.assert_array_equal(got[touched], want[touched])
    assert (got[~touched].view(np.int32) == np.float32(-0.0).view(np.int32)
            ).all(), "an untouched -0.0 row was written"


def test_cpu_tensors_take_the_plain_route_and_count_it():
    """The wrappers count plain calls for CPU tensors and never count a
    launch there."""
    tops.reset_counts()
    lp, vals = _push_inputs(64, 128, 0.5, 4)
    tops.zen_commit_push_fused_op(_t(lp), _t(vals), cap_server=64,
                                  cap_pull=32)
    tops.zen_commit_pull_fused_op(torch.zeros((2, 2), dtype=torch.int32),
                                  64, 32)
    idx = torch.arange(10, dtype=torch.int32)
    tops.zen_encode_fused_op(idx, _seeds(), 2, 16, 4)
    assert tops.PLAIN_CALLS == {k: int(k in tops.FUSED_KERNELS)
                                for k in tops.KERNELS}
    assert tops.LAUNCHES == dict.fromkeys(tops.KERNELS, 0)
    tops.reset_counts()
    assert tops.PLAIN_CALLS == dict.fromkeys(tops.KERNELS, 0)
