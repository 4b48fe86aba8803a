"""Port parity: gradient buckets (``core/buckets.py``) and the bucketed
GradSync on the in-process group, against the reference's
``repro.core.buckets`` / ``GradSync`` (mirrors tests/test_buckets.py).

* the plan's buckets equal the reference's ``make_bucket_plan`` on the same
  leaves, slot by slot (names, indices, offsets, sizes, dtypes, bytes);
* ``bucket_bytes <= 0`` raises, ``validate`` rejects malformed plans;
* GradSync's synced values are bitwise invariant over bucket sizes, equal
  the reference's bit for bit (zen and dense), and zen equals dense at every
  size; overflow and the reduced metrics equal the reference's at every
  size.

Gradients are numpy draws from a seed, dyadic with few bits (multiples of
1/8 up to 4), so every sum is exact in f32 and in bf16 alike; the hash
seeds are the reference layouts'.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import buckets as rbk
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro_torch.core import buckets as bk
from repro_torch.core import schemes as TS
from repro_torch.core.zen import GradSync, SyncConfig

N = 4
SPARSE_PATHS = ["embed/table", "out_embed/table"]
TORCH_DTYPE = {jnp.dtype(jnp.float32): torch.float32,
               jnp.dtype(jnp.bfloat16): torch.bfloat16}
SIZES = [1, 64, 257, 1024, 8192, 1 << 22]
STAT_KEYS = ("sync/sparse_sent_words", "sync/dense_words", "sync/overflow")


def _shapes(extra_table=True, rows=256):
    f32, bf16 = jnp.float32, jnp.bfloat16
    shapes = {
        "embed": {"table": jax.ShapeDtypeStruct((rows, 8), f32)},
        "mlp": {"w1": jax.ShapeDtypeStruct((32, 16), f32),
                "w2": jax.ShapeDtypeStruct((16, 32), f32),
                "b": jax.ShapeDtypeStruct((7,), f32)},
        "norm": {"g": jax.ShapeDtypeStruct((16,), f32),
                 "b16": jax.ShapeDtypeStruct((16,), bf16),
                 "c16": jax.ShapeDtypeStruct((4, 4), bf16)},
    }
    if extra_table:
        shapes["out_embed"] = {"table": jax.ShapeDtypeStruct((64, 4), f32)}
    return shapes


def _leaves(shapes):
    """The reference's flatten order as the port's (name, shape, dtype)."""
    return [(rbk.leaf_path_str(path), tuple(s.shape),
             TORCH_DTYPE[jnp.dtype(s.dtype)])
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _grads(shapes, density=0.1, seed=0):
    """{name: float32 numpy [N, ...]}: multiples of 1/8 in [-4, 4]; the
    tables' rows kept with probability ``density``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, _ in _leaves(shapes):
        g = np.clip(np.round(rng.standard_normal((N, *shape)) * 8), -32, 32) / 8
        if "table" in name:
            g *= (rng.random((N, shape[0])) < density)[..., None]
        out[name] = g.astype(np.float32)
    return out


def _ref_tree(shapes, grads):
    def leaf(path, s):
        return jnp.asarray(grads[rbk.leaf_path_str(path)]).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _ref_run(shapes, grads, bucket_bytes, scheme="zen", budget=0.5):
    gs = RefGradSync(RefSyncConfig(scheme=scheme, density_budget=budget,
                                   bucket_bytes=bucket_bytes),
                     SPARSE_PATHS, shapes, N, data_axis="data")
    out, stats = jax.vmap(gs, axis_name="data")(_ref_tree(shapes, grads))
    flat = {rbk.leaf_path_str(p): np.asarray(v.astype(jnp.float32))
            for p, v in jax.tree_util.tree_flatten_with_path(out)[0]}
    return gs, flat, {k: np.asarray(v) for k, v in stats.items()}


def _port_run(shapes, grads, bucket_bytes, ref_gs, scheme="zen",
              budget=0.5):
    leaves = _leaves(shapes)
    gs = GradSync(SyncConfig(scheme=scheme, density_budget=budget,
                             bucket_bytes=bucket_bytes),
                  SPARSE_PATHS, leaves, N)
    for key in list(gs._layouts):   # the reference's hash seeds
        lo = ref_gs._layouts[key]
        gs._layouts[key] = TS.make_zen_layout(
            lo.length, N, density_budget=budget, seeds=lo.seeds)
    out, stats = gs({name: torch.from_numpy(grads[name]).to(dt)
                     for name, _, dt in leaves})
    return gs, {k: v.float().numpy() for k, v in out.items()}, \
        {k: v.numpy() for k, v in stats.items()}


@pytest.fixture(scope="module")
def refs():
    """The reference GradSync's outputs on the default case, per scheme
    (its own tests hold them invariant over bucket sizes)."""
    shapes = _shapes()
    grads = _grads(shapes)
    return {scheme: _ref_run(shapes, grads, None, scheme)
            for scheme in ("zen", "dense")}


# ---------------------------------------------------------------------------
# plan structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes", [None, 1, 1024, 4096, 1 << 20])
def test_plan_equals_reference_slot_by_slot(bucket_bytes):
    shapes = _shapes()
    ref = rbk.make_bucket_plan(
        shapes, lambda nm: nm in SPARSE_PATHS, bucket_bytes,
        lambda nm, leaf: "zen")
    got = bk.make_bucket_plan(
        _leaves(shapes), lambda nm: nm in SPARSE_PATHS, bucket_bytes,
        lambda nm, shape: "zen")
    got.validate()
    assert got.n_leaves == ref.n_leaves
    assert got.bucket_bytes == ref.bucket_bytes
    assert got.schemes == ref.schemes
    assert len(got.buckets) == len(ref.buckets)
    for gb, rb in zip(got.buckets, ref.buckets):
        assert (gb.bid, gb.kind, gb.scheme, gb.nbytes, gb.size, gb.key) == \
            (rb.bid, rb.kind, rb.scheme, rb.nbytes, rb.size, rb.key)
        assert len(gb.slots) == len(rb.slots)
        for gs, rs in zip(gb.slots, rb.slots):
            assert (gs.name, gs.index, gs.shape, gs.offset, gs.size) == \
                (rs.name, rs.index, tuple(rs.shape), rs.offset, rs.size)
            assert gs.dtype == TORCH_DTYPE[jnp.dtype(rs.dtype)]


def test_fallback_is_one_bucket_per_leaf():
    plan = bk.make_bucket_plan(_leaves(_shapes()),
                               lambda nm: nm in SPARSE_PATHS, None,
                               lambda nm, shape: "zen")
    assert len(plan.buckets) == plan.n_leaves
    assert all(len(b.slots) == 1 for b in plan.buckets)


@pytest.mark.parametrize("bucket_bytes", [0, -1])
def test_bad_bucket_bytes_rejected(bucket_bytes):
    with pytest.raises(ValueError, match="bucket_bytes"):
        GradSync(SyncConfig(bucket_bytes=bucket_bytes), SPARSE_PATHS,
                 _leaves(_shapes()), N)


def _slot(name, index, size, offset=0):
    return bk.LeafSlot(name, index, (size,), torch.float32, offset, size)


@pytest.mark.parametrize("fault", ["twice", "sparse-fused", "over-budget",
                                   "missing"])
def test_validate_rejects_malformed_plans(fault):
    a, b = _slot("a", 0, 4), _slot("b", 1, 4, offset=4)
    buckets = {
        "twice": (bk.Bucket(0, bk.DENSE, "dense", (a,), 16),
                  bk.Bucket(1, bk.DENSE, "dense", (a, b), 32)),
        "sparse-fused": (bk.Bucket(0, bk.SPARSE, "zen", (a, b), 32),),
        "over-budget": (bk.Bucket(0, bk.DENSE, "dense", (a, b), 32),),
        "missing": (bk.Bucket(0, bk.DENSE, "dense", (a,), 16),),
    }[fault]
    plan = bk.BucketPlan(buckets=buckets, n_leaves=2, bucket_bytes=16)
    with pytest.raises(ValueError):
        plan.validate()


def test_gather_and_scatter_round_trip():
    plan = bk.make_bucket_plan(_leaves(_shapes()),
                               lambda nm: nm in SPARSE_PATHS, 1 << 20,
                               lambda nm, shape: "zen")
    rng = np.random.default_rng(3)
    flat = [torch.from_numpy(rng.standard_normal((N, *s)).astype(np.float32))
            .to(dt) for _, s, dt in _leaves(_shapes())]
    out = [None] * len(flat)
    for b in plan.buckets:
        p = bk.gather_bucket(b, flat)
        assert p.shape == ((N, *b.slots[0].shape) if b.kind == bk.SPARSE
                           else (N, b.size))
        bk.scatter_bucket(b, p, out)
    for a, b in zip(flat, out):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# GradSync over bucket sizes (the multi-bucket SyncStats contract)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket_bytes", [None] + SIZES)
@pytest.mark.parametrize("scheme", ["zen", "dense"])
def test_gradsync_bitwise_invariant_and_equal_to_reference(refs, scheme,
                                                           bucket_bytes):
    shapes = _shapes()
    ref_gs, ref_out, ref_st = refs[scheme]
    _, out, st = _port_run(shapes, _grads(shapes), bucket_bytes, ref_gs,
                           scheme)
    for name in ref_out:
        np.testing.assert_array_equal(out[name], ref_out[name],
                                      err_msg=name)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(st[k], ref_st[k], err_msg=k)


@pytest.mark.parametrize("bucket_bytes", [None, 512, 1 << 20])
def test_zen_dense_parity_per_bucket_size(refs, bucket_bytes):
    shapes = _shapes()
    grads = _grads(shapes)
    _, out_z, _ = _port_run(shapes, grads, bucket_bytes, refs["zen"][0])
    _, out_d, _ = _port_run(shapes, grads, bucket_bytes, refs["zen"][0],
                            "dense")
    for name in out_z:
        np.testing.assert_array_equal(out_z[name], out_d[name], err_msg=name)


def test_overflow_surfaces_identically_across_bucket_sizes():
    """An undersized capacity reports the reference's overflow for every
    plan."""
    shapes = {"embed": {"table": jax.ShapeDtypeStruct((256, 4),
                                                      jnp.float32)},
              "w": jax.ShapeDtypeStruct((64,), jnp.float32)}
    grads = _grads(shapes, density=0.9)
    counts = []
    for bb in (None, 128, 1 << 20):
        ref_gs, _, ref_st = _ref_run(shapes, grads, bb, budget=0.05)
        _, _, st = _port_run(shapes, grads, bb, ref_gs, budget=0.05)
        np.testing.assert_array_equal(st["sync/overflow"],
                                      ref_st["sync/overflow"])
        counts.append(st["sync/overflow"])
    assert int(counts[0].sum()) > 0
    for c in counts[1:]:
        np.testing.assert_array_equal(counts[0], c)


@pytest.mark.parametrize("bucket_bytes", [None, 1024, 1 << 20])
def test_reduce_stats_equal_reference(refs, bucket_bytes):
    """Every metric, the bucket counts by scheme included, equals the
    reference GradSync's at the same bucket size."""
    shapes = _shapes()
    grads = _grads(shapes)
    ref_gs, _, ref_st = _ref_run(shapes, grads, bucket_bytes)
    gs, _, st = _port_run(shapes, grads, bucket_bytes, ref_gs)
    assert sorted(st) == sorted(ref_st)
    for k in st:
        np.testing.assert_array_equal(st[k], ref_st[k], err_msg=k)
    n_dense = sum(b.kind == bk.DENSE for b in gs.plan.buckets)
    assert float(st["sync/buckets[dense]"][0]) == n_dense
    dense_elems = sum(b.size for b in gs.plan.buckets if b.kind == bk.DENSE)
    np.testing.assert_allclose(st["sync/dense_words"][0],
                               2 * (N - 1) / N * dense_elems, rtol=1e-6)


@pytest.mark.parametrize("bucket_bytes", [None, 1024])
def test_describe_is_the_references(refs, bucket_bytes):
    shapes = _shapes()
    ref_gs = RefGradSync(RefSyncConfig(bucket_bytes=bucket_bytes),
                         SPARSE_PATHS, shapes, N, data_axis="data")
    gs = GradSync(SyncConfig(bucket_bytes=bucket_bytes), SPARSE_PATHS,
                  _leaves(shapes), N)
    assert gs.describe() == ref_gs.describe()
