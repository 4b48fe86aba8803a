"""Port parity: two-level topologies (``hier_sync``, ``simulate_hier``,
GradSync on a ``--node-size`` topology, pod meshes) against the reference.

* ``simulate_hier`` of the five plan tags of tests/test_hier_schemes.py at
  node_size 2 and 4 (n = 8), ``stage_kw`` from ``plan_stage_args`` (the
  reference layouts' hash seeds), both routes: outputs, ``sent_words``,
  overflow and each level's words (``by_level``) bitwise the reference's;
* GradSync on a two-level topology over two steps, per leaf, bucketed and
  with ``compress="topk:0.01"``: synced grads, EF residuals, the stats
  (``sync/intra_words``, ``sync/inter_words``, overflow) and the
  ``describe()`` lines bitwise the reference's (its GradSync under nested
  ``jax.vmap`` with one axis name a level, as ``simulate_hier`` runs);
* the dyadic invariance of the reference's
  ``test_gradsync_values_invariant_across_node_sizes``, and node_size 1
  bitwise the flat GradSync with the same stats keys;
* ``auto``'s plan tags equal the reference's for the qwen2-0.5b,
  qwen2.5-3b and phi4-mini embeddings and for compressed buckets;
* the two-stream schedule with its ``intra`` hook bitwise ``run_in_order``;
* a ``2x4x1`` pod mesh's GradSync against the reference's with
  ``pod_axis`` (nested ``jax.vmap`` over pod and data), flat and
  node-split.

The launcher's two-level runs are in tests/test_torch_hier_launch.py.

Gradients are numpy draws from a seed, dyadic (multiples of 1/8 up to 4 or
of 1/256), so every sum is exact whatever its order.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import buckets as rbk
from repro.core import schemes as S
from repro.core import topology as RT
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro_torch.core import schemes as TS
from repro_torch.core import topology as TT
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.train import schedule

N, M = 8, 2048
PLANS = ["hier(zen@intra,zen@inter)", "hier(zen@intra,agsparse@inter)",
         "hier(dense@intra,sparcml@inter)", "hier(agsparse@intra,dense@inter)",
         "hier(zen@intra,dense@inter)"]
SPARSE_PATHS = ["embed/table"]


def _workers(seed, n, m, density, d=None):
    """float32 [n, m(, d)]: multiples of 1/256, rows kept with probability
    ``density`` (a Zipf-free uniform mask)."""
    rng = np.random.default_rng(seed)
    shape = (n, m) if d is None else (n, m, d)
    vals = np.round(rng.standard_normal(shape) * 256) / 256
    mask = rng.random((n, m)) < density
    return (vals * (mask if d is None else mask[..., None])).astype(
        np.float32)


def _port_layout(lo) -> TS.ZenLayout:
    """The reference layout's fields as the port's ZenLayout."""
    return TS.ZenLayout(
        n=int(lo.n), length=int(lo.length),
        seeds=np.asarray(lo.seeds, np.uint32),
        perm=np.asarray(lo.perm, np.int32),
        offsets=np.asarray(lo.offsets, np.int32),
        local_pos=np.asarray(lo.local_pos, np.int32),
        cap_server=int(lo.cap_server), cap_index=int(lo.cap_index),
        r1=int(lo.r1), r2=int(lo.r2), k=int(lo.k))


def _equal(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        err_msg=what)


# ---------------------------------------------------------------------------
# hier_sync / simulate_hier
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_hier(tag: str, node_size: int, d):
    vals = _workers(1, N, M, 0.05, d)
    topo = RT.build_topology(N, node_size)
    plan = RT.parse_plan(tag)
    kw = S.plan_stage_args(plan, topo, M, density_budget=0.3)
    fn = jax.jit(functools.partial(S.simulate_hier, topology=topo, plan=plan,
                                   stage_kw=kw))
    out, st = fn(jnp.asarray(vals))
    return vals, kw, (np.asarray(out), np.asarray(st.sent_words),
                      np.asarray(st.overflow),
                      [np.asarray(w) for w in st.by_level])


HIER_CASES = ([(t, ns, None) for t in PLANS for ns in (2, 4)]
              + [(PLANS[0], ns, 8) for ns in (2, 4)])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize(
    "tag,node_size,d", HIER_CASES,
    ids=[f"{t}-ns{ns}-{'row' if d else 'elem'}" for t, ns, d in HIER_CASES])
def test_simulate_hier_bitwise_vs_reference(tag, node_size, d, backend):
    vals, ref_kw, (r_out, r_sent, r_ovf, r_lvl) = _ref_hier(tag, node_size, d)
    topo = TT.build_topology(N, node_size)
    plan = TT.parse_plan(tag)
    seeds = next((a.layout.seeds for a in ref_kw.values()
                  if a.layout is not None), None)
    kw = TS.plan_stage_args(plan, topo, M, density_budget=0.3,
                            backend=backend, seeds=seeds)
    assert sorted(kw) == sorted(ref_kw)
    for lvl, a in kw.items():   # the same provisioning, level by level
        if a.layout is not None:
            assert a.layout.cap_index == ref_kw[lvl].layout.cap_index
            assert a.layout.cap_server == ref_kw[lvl].layout.cap_server
        assert a.capacity == ref_kw[lvl].capacity
    out, st = TS.simulate_hier(torch.from_numpy(vals), topology=topo,
                               plan=plan, stage_kw=kw)
    np.testing.assert_array_equal(out.numpy(), r_out)
    np.testing.assert_array_equal(st.sent_words.numpy(), r_sent)
    np.testing.assert_array_equal(st.overflow.numpy(), r_ovf)
    assert len(st.by_level) == len(r_lvl) == 2
    for got, want in zip(st.by_level, r_lvl):
        np.testing.assert_array_equal(got.numpy(), want)
    assert not st.overflow.any()
    np.testing.assert_array_equal(out.numpy(),
                                  np.broadcast_to(vals.sum(0), out.shape))


def test_size_one_level_is_skipped_with_zero_words():
    """node_size == n: the inter level has one node; it is skipped and
    reports zero words, as the reference's is."""
    vals = _workers(2, N, M, 0.05)
    topo = TT.build_topology(N, N)
    plan = TT.parse_plan("hier(zen@intra,agsparse@inter)")
    kw = TS.plan_stage_args(plan, topo, M, density_budget=0.3)
    assert sorted(kw) == [0]
    out, st = TS.simulate_hier(torch.from_numpy(vals), topology=topo,
                               plan=plan, stage_kw=kw)
    assert not st.by_level[1].any() and st.by_level[0].all()
    np.testing.assert_array_equal(out.numpy(),
                                  np.broadcast_to(vals.sum(0), out.shape))


def test_level_groups_are_the_reference_layout():
    """Intra groups are consecutive ranks, inter groups strided; the pod
    axis is outermost."""
    assert TS.level_rows((1, 2, 4), 2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert TS.level_rows((1, 2, 4), 1) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert TS.level_rows((2, 4), 0) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert TS.level_rows((2, 2, 2), 0)[0] == [0, 4]
    with pytest.raises(ValueError, match="cover"):
        TS.SimGroup(8).split((2, 2), 1)


# ---------------------------------------------------------------------------
# GradSync on a two-level topology
# ---------------------------------------------------------------------------

def _shapes(dtype=jnp.float32):
    return {"embed": {"table": jax.ShapeDtypeStruct((256, 8), jnp.float32)},
            "mlp": {"w1": jax.ShapeDtypeStruct((32, 16), dtype),
                    "b": jax.ShapeDtypeStruct((7,), jnp.float32)},
            "norm": {"g": jax.ShapeDtypeStruct((96,), dtype)}}


def _leaves(shapes):
    td = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}
    return [(rbk.leaf_path_str(p), tuple(s.shape), td[jnp.dtype(s.dtype)])
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _grads(leaves, seed, n=N, density=0.1):
    """{name: float32 [n, ...]}: multiples of 1/8 in [-4, 4]; the table's
    rows kept with probability ``density``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, _ in leaves:
        g = np.clip(np.round(rng.standard_normal((n, *shape)) * 8), -32,
                    32) / 8
        if name in SPARSE_PATHS:
            g *= (rng.random((n, shape[0])) < density)[..., None]
        out[name] = g.astype(np.float32)
    return out


def _nest(x, sizes):
    return x.reshape(*sizes, *x.shape[1:])


def _ref_runner(gs, sizes, axes, compressed):
    """The reference GradSync under one nested ``jax.vmap`` per mesh axis
    (outermost first), jitted: ``run(tree [n, ...], residual, step)``."""
    if compressed:
        fn = lambda g, r, t: gs(g, r, step=t)   # noqa: E731
        in_axes = (0, 0, None)
    else:
        fn = lambda g, r, t: gs(g)               # noqa: E731
        in_axes = (0, None, None)
    for ax in reversed(axes):
        fn = jax.vmap(fn, in_axes=in_axes, axis_name=ax)
    fn = jax.jit(fn)
    n = int(np.prod(sizes))

    def run(tree, residual, step):
        tree = jax.tree.map(lambda x: _nest(x, sizes), tree)
        res = (jax.tree.map(lambda x: _nest(x, sizes), residual)
               if compressed else None)
        out = fn(tree, res, jnp.int32(step))
        return jax.tree.map(lambda x: x.reshape(n, *x.shape[len(sizes):]),
                            out)
    return run


def _ref_tree(shapes, grads):
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(grads[rbk.leaf_path_str(p)]).astype(s.dtype),
        shapes)


def _flat(tree):
    return {rbk.leaf_path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_gradsync(cfg, shapes, node_size, pods=1, n=N):
    """(reference GradSync, nested-vmap runner) over ``pods`` x ``n``."""
    topo = RT.build_topology(n, node_size)
    gs = RefGradSync(cfg, SPARSE_PATHS, shapes, n, data_axis="data",
                     pod_axis="pod" if pods > 1 else None, topology=topo)
    head = ((pods,), ("pod",)) if pods > 1 else ((), ())
    if topo.flat:
        sizes, axes = (*head[0], n), (*head[1], "data")
    else:
        sizes = (*head[0], topo.inter.size, topo.intra.size)
        axes = (*head[1], topo.inter.axis, topo.intra.axis)
    return gs, _ref_runner(gs, sizes, axes, cfg.compress != "none")


def _port_gradsync(cfg, shapes, node_size, ref_gs, pods=1, n=N):
    gs = GradSync(cfg, SPARSE_PATHS, _leaves(shapes), n,
                  topology=TT.build_topology(n, node_size), pods=pods)
    assert sorted(gs._layouts) == sorted(ref_gs._layouts)
    for key in gs._layouts:   # the reference's layouts (its hash seeds)
        gs._layouts[key] = _port_layout(ref_gs._layouts[key])
    return gs


GS_CASES = [("zen", None, "none"), ("zen", 1024, "none"),
            ("auto", 1024, "none"), ("zen", 1 << 20, "topk:0.01"),
            ("auto", 1 << 20, "topk:0.01")]


@pytest.mark.parametrize("node_size", [2, 4])
@pytest.mark.parametrize("scheme,bucket_bytes,compress", GS_CASES)
def test_gradsync_two_level_bitwise_vs_reference(scheme, bucket_bytes,
                                                 compress, node_size):
    shapes = _shapes(jnp.bfloat16 if compress != "none" else jnp.float32)
    kw = dict(scheme=scheme, density_budget=0.5, bucket_bytes=bucket_bytes,
              compress=compress)
    ref_gs, run = _ref_gradsync(RefSyncConfig(**kw), shapes, node_size)
    leaves = _leaves(shapes)
    for backend in ("torch", "cuda"):
        gs = _port_gradsync(SyncConfig(backend=backend, **kw), shapes,
                            node_size, ref_gs)
        assert gs.describe() == ref_gs.describe()
        assert [b.scheme for b in gs.plan.buckets] == \
            [b.scheme for b in ref_gs.plan.buckets]
        res_ref = {k: jnp.zeros((N, s), jnp.float32)
                   for k, s in ref_gs.compressed_buckets().items()}
        res = gs.init_residual("cpu")
        for step in range(2):
            grads = _grads(leaves, 10 * node_size + step)
            out_ref = run(_ref_tree(shapes, grads), res_ref, step)
            tg = {nm: torch.from_numpy(grads[nm]).to(dt)
                  for nm, _, dt in leaves}
            if compress != "none":
                r_synced, res_ref, r_st = out_ref
                synced, res, st = gs(tg, res, step=step)
                for k in res_ref:
                    _equal(res[k], res_ref[k], f"step {step} residual {k}")
            else:
                r_synced, r_st = out_ref
                synced, st = gs(tg)
            r_synced = _flat(r_synced)
            what = f"{scheme} {backend} step {step}"
            for nm, _, _ in leaves:
                _equal(synced[nm], r_synced[nm], f"{what} {nm}")
            assert set(st) == set(r_st)
            assert {"sync/intra_words", "sync/inter_words"} <= set(st)
            for k in r_st:
                _equal(st[k], r_st[k], f"{what} {k}")
            assert not st["sync/overflow"].any()


@pytest.mark.parametrize("scheme", ["zen", "dense", "auto"])
@pytest.mark.parametrize("node_size", [1, 2, 4, 8])
def test_gradsync_values_invariant_across_node_sizes(scheme, node_size):
    """Synced values bitwise identical (dyadic grads) for every node
    grouping of the same 8 workers, and equal to the reference's flat
    GradSync; node_size 1 is the flat GradSync bit for bit, stats
    included."""
    shapes = _shapes()
    leaves = _leaves(shapes)
    grads = _grads(leaves, 0)
    tg = {nm: torch.from_numpy(grads[nm]) for nm, _, _ in leaves}
    cfg = SyncConfig(scheme=scheme, density_budget=0.5, bucket_bytes=1024)
    ref_gs, run = _ref_gradsync(
        RefSyncConfig(scheme=scheme, density_budget=0.5, bucket_bytes=1024),
        shapes, 1)
    r_out = _flat(run(_ref_tree(shapes, grads), None, 0)[0])
    flat = _port_gradsync(cfg, shapes, 1, ref_gs)
    gs = (_port_gradsync(cfg, shapes, 1, ref_gs) if node_size == 1
          else GradSync(cfg, SPARSE_PATHS, leaves, N,
                        topology=TT.build_topology(N, node_size)))
    out0, st0 = flat(tg)
    out, st = gs(tg)
    for nm, _, _ in leaves:
        _equal(out[nm], r_out[nm], nm)
        assert torch.equal(out[nm], out0[nm]), nm
    assert not st["sync/overflow"].any()
    if node_size > 1:
        assert {"sync/intra_words", "sync/inter_words"} <= set(st)
    else:
        assert [b.scheme for b in gs.plan.buckets] == \
            [b.scheme for b in flat.plan.buckets]
        assert set(st) == set(st0)
        for k in st0:
            assert torch.equal(st[k], st0[k]), k


# the untied embeddings of the Motivation's table: qwen2-0.5b, qwen2.5-3b,
# phi4-mini; (n, node_size) with the reference's plan for each
EMBEDS = {"qwen2-0.5b": (151936, 896), "qwen2.5-3b": (151936, 2048),
          "phi4-mini": (200064, 3072)}
AUTO_CASES = [(a, 8, ns) for a in EMBEDS for ns in (2, 4)] + \
    [("qwen2-0.5b", 4, 2)]
EXPECTED = {(8, 2): "hier(agsparse@intra,zen@inter)",
            (8, 4): "hier(sparcml@intra,dense@inter)",
            (4, 2): "hier(agsparse@intra,agsparse@inter)"}


@pytest.mark.parametrize("arch,n,node_size", AUTO_CASES)
def test_auto_plan_tags_equal_reference(arch, n, node_size):
    rows, d = EMBEDS[arch]
    shapes = {"embed": {"table": jax.ShapeDtypeStruct((rows, d),
                                                      jnp.bfloat16)},
              "w": jax.ShapeDtypeStruct((64,), jnp.bfloat16)}
    topo_kw = dict(data_axis="data",
                   topology=RT.build_topology(n, node_size))
    ref = RefGradSync(RefSyncConfig(scheme="auto"), SPARSE_PATHS, shapes, n,
                      **topo_kw)
    gs = GradSync(SyncConfig(scheme="auto"), SPARSE_PATHS, _leaves(shapes),
                  n, topology=TT.build_topology(n, node_size))
    assert [b.scheme for b in gs.plan.buckets] == \
        [b.scheme for b in ref.plan.buckets]
    assert gs.plan.buckets[0].scheme == EXPECTED[n, node_size]
    assert gs.describe() == ref.describe()
    # on the flat topology the same table takes zen
    flat = GradSync(SyncConfig(scheme="auto"), SPARSE_PATHS,
                    _leaves(shapes), n)
    assert flat.plan.buckets[0].scheme == "zen"


@pytest.mark.parametrize("node_size", [2, 4])
def test_auto_compressed_bucket_tags_equal_reference(node_size):
    shapes = _shapes(jnp.bfloat16)
    kw = dict(scheme="auto", bucket_bytes=256, compress="topk:0.01")
    ref = RefGradSync(RefSyncConfig(**kw), SPARSE_PATHS, shapes, N,
                      data_axis="data",
                      topology=RT.build_topology(N, node_size))
    gs = GradSync(SyncConfig(**kw), SPARSE_PATHS, _leaves(shapes), N,
                  topology=TT.build_topology(N, node_size))
    assert gs.bucket_schemes() == ref.bucket_schemes()
    assert [b.scheme for b in gs.plan.buckets] == \
        [b.scheme for b in ref.plan.buckets]
    assert all(s.startswith("hier(") for s in gs.bucket_schemes().values())


@pytest.mark.parametrize("node_size", [2, 4])
def test_schedule_intra_hook_bitwise_run_in_order(node_size):
    shapes = _shapes()
    leaves = _leaves(shapes)
    grads = _grads(leaves, 5)
    tg = {nm: torch.from_numpy(grads[nm]) for nm, _, _ in leaves}
    gs = GradSync(SyncConfig(bucket_bytes=1024, density_budget=0.5),
                  SPARSE_PATHS, leaves, N,
                  topology=TT.build_topology(N, node_size))
    hooks = (gs._encode_bucket, gs._commit_bucket)
    runs = []
    for fn in (schedule.run_schedule, schedule.run_in_order):
        flat, payloads = gs._payloads(tg)
        outs, stats = fn(gs.plan.buckets, payloads, *hooks,
                         intra=gs._intra_bucket)
        runs.append((outs, stats))
    (a_out, a_st), (b_out, b_st) = runs
    for x, y in zip(a_out, b_out):
        assert torch.equal(x, y)
    for x, y in zip(a_st, b_st):
        assert all(torch.equal(p, q) for p, q in zip(x[:2], y[:2]))
        assert len(x.by_level) == 2
        assert all(torch.equal(p, q) for p, q in zip(x.by_level, y.by_level))


# ---------------------------------------------------------------------------
# pods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["zen", "auto"])
@pytest.mark.parametrize("node_size", [1, 2])
def test_pod_mesh_gradsync_bitwise_vs_reference(node_size, scheme):
    """A 2x4x1 mesh: each pod syncs its 4 data ranks (flat or two nodes of
    2), then the pods' mean, as the reference's GradSync with ``pod_axis``
    under nested vmap."""
    pods, n = 2, 4
    shapes = _shapes()
    leaves = _leaves(shapes)
    cfg = dict(scheme=scheme, density_budget=0.5, bucket_bytes=1024)
    ref_gs, run = _ref_gradsync(RefSyncConfig(**cfg), shapes, node_size,
                                pods=pods, n=n)
    gs = _port_gradsync(SyncConfig(**cfg), shapes, node_size, ref_gs,
                        pods=pods, n=n)
    assert gs.group.n == pods * n
    assert gs.describe() == ref_gs.describe()
    for step in range(2):
        grads = _grads(leaves, 30 + step, n=pods * n)
        r_out, r_st = run(_ref_tree(shapes, grads), None, step)
        r_out = _flat(r_out)
        out, st = gs({nm: torch.from_numpy(grads[nm])
                      for nm, _, _ in leaves})
        for nm, _, _ in leaves:
            _equal(out[nm], r_out[nm], f"step {step} {nm}")
        assert set(st) == set(r_st)
        for k in r_st:
            _equal(st[k], r_st[k], f"step {step} {k}")
