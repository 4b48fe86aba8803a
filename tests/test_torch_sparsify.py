"""Port parity: EF gradient compression (``core/sparsify.py``), the
compressed bucket plan and the compressed GradSync, against the
reference's ``repro.core.sparsify`` / ``GradSync`` (mirrors
tests/test_sparsify.py).

* ``parse_compress`` accepts and rejects the reference's specs, with the
  same fields and round-trippable tags;
* ``compress_bucket`` (topk, threshold; f32 and bf16 payloads, with and
  without a residual, and a payload with deliberate ties at the k-th
  value) gives the reference's sent, residual and density bit for bit;
  the EF invariant is exact for all three kinds; randk is deterministic in
  (seed, bucket, step), differs across steps and keeps a binomial share;
* the compressed bucket plan equals the reference's slot by slot, tags
  included, and a compressed row-sparse bucket is rejected;
* GradSync on the reduced qwen2 leaves at n = 4 with ``topk:0.01`` and
  ``threshold:3.5`` equals the reference's (``jax.vmap`` over ``data``)
  bit for bit on both routes over two steps (synced values, residuals,
  words, overflow, EF densities); compressed zen equals compressed dense
  (residuals bitwise, synced within 1e-5); topk:0.01 sends under 10 % of
  the dense words; ``:noef`` keeps no state; EF without a residual raises;
* under ``--sync auto`` the compressed GradSync resolves every bucket as
  the reference's does (zen at ``topk:0.01``) and runs its two steps
  bitwise the reference's;
* ``compress_profile`` and ``measured_profile`` give the reference's
  curves and picks, and ``DensityController`` fed the reference's metric
  sequences gives its ``schemes()`` and ``drifted()`` step by step
  (tests/test_sparsify.py's controller cases), and its profiles replan a
  GradSync per bucket.

Gradients are numpy draws from a seed, dyadic with few bits (multiples
of 1/8 up to 4), so every sum the schemes take is exact and the compressed
payloads tie often at the k-th value; the hash seeds are the reference
layouts'.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.core import buckets as rbk
from repro.core import costmodel as rcm
from repro.core import sparsify as rsp
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro_torch.core import buckets as bk
from repro_torch.core import costmodel as TC
from repro_torch.core import schemes as TS
from repro_torch.core import sparsify as sp
from repro_torch.core.zen import GradSync, SyncConfig

N = 4
SPARSE_PATHS = ["embed/table"]
TORCH_DTYPE = {jnp.dtype(jnp.float32): torch.float32,
               jnp.dtype(jnp.bfloat16): torch.bfloat16}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here: the suite runs in parallel
    workers, where torch's default pool oversubscribes the cores and these
    tests' many small ops on ~1M-element tensors slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def _np(t) -> np.ndarray:
    """A port tensor or a reference array as numpy (bf16 as f32)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _equal(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


# ---------------------------------------------------------------------------
# config parsing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["topk:0.01", "randk:0.05", "topk:0.02:noef",
                                  "threshold:1e-3", "none", None])
def test_parse_compress_matches_reference(spec):
    got, ref = sp.parse_compress(spec), rsp.parse_compress(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.tag() == ref.tag() and got.enabled == ref.enabled
    assert sp.parse_compress(got.tag()) == got
    for size in (1, 7, 1000, 123457):
        assert got.keep_count(size) == ref.keep_count(size)


@pytest.mark.parametrize("bad", ["topk", "topk:0", "topk:2.0", "magic:0.1",
                                 "topk:0.1:what"])
def test_parse_compress_rejects(bad):
    with pytest.raises(ValueError):
        rsp.parse_compress(bad)
    with pytest.raises(ValueError):
        sp.parse_compress(bad)


# ---------------------------------------------------------------------------
# compress_bucket against the reference
# ---------------------------------------------------------------------------

def _payload(size, seed, dtype=np.float32, ties=False):
    rng = np.random.default_rng(seed)
    if ties:   # few distinct magnitudes: many ties at the k-th value
        g = rng.integers(-3, 4, size).astype(np.float32) / 4
    else:
        g = rng.standard_normal(size).astype(np.float32)
    return g if dtype == np.float32 else g  # cast at the call sites


def _both(g: np.ndarray, dtype: torch.dtype):
    t = torch.from_numpy(g).to(dtype)
    return t, jnp.asarray(g).astype(JAX_DTYPE[dtype])


@pytest.mark.parametrize("spec", ["topk:0.05", "topk:0.3", "threshold:0.8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_bucket_bitwise_reference(spec, dtype, ties, with_residual):
    cfg, rcfg = sp.parse_compress(spec), rsp.parse_compress(spec)
    g, rg = _both(_payload(1000, 1, ties=ties), dtype)
    r = rr = None
    if with_residual:
        rn = _payload(1000, 2, ties=ties) * 0.25
        r, rr = torch.from_numpy(rn), jnp.asarray(rn)
    sent, res, d1 = sp.compress_bucket(cfg, g, r)
    rsent, rres, rd1 = rsp.compress_bucket(rcfg, rg, rr)
    _equal(sent, rsent, "sent")
    assert sent.dtype == dtype
    if with_residual:
        _equal(res, rres, "residual")
    else:
        assert res is None and rres is None
    _equal(d1, rd1, "density")
    if ties and cfg.kind == "topk":   # the case exercises the tie rule
        a = (g.float() + (r if r is not None else 0)).abs()
        kth = torch.topk(a, cfg.keep_count(1000)).values[-1]
        assert int((a == kth).sum()) > int(((sent != 0) & (a == kth)).sum())


def test_topk_ties_go_to_lowest_indices():
    cfg = sp.parse_compress("topk:0.01")
    g = torch.zeros(10_000)
    g[::7] = 1.0                                   # 1429 ties, k = 100
    sent, _, d1 = sp.compress_bucket(cfg, g, None)
    kept = torch.nonzero(sent).flatten()
    assert kept.tolist() == list(range(0, 700, 7))
    assert float(d1) == pytest.approx(0.01, rel=1e-6)


@pytest.mark.parametrize("kind", ["topk", "threshold", "randk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ef_invariant_exact(kind, dtype):
    """sent + residual' == payload + residual in f32, exactly."""
    cfg = sp.CompressConfig(kind=kind, density=0.1, threshold=0.5)
    g = torch.from_numpy(_payload(3000, 3)).to(dtype)
    r = torch.from_numpy(_payload(3000, 4)) * 0.1
    sent, r2, _ = sp.compress_bucket(cfg, g, r, seed=sp.randk_seed(0, 1, 2))
    assert sent.dtype == dtype
    assert torch.equal(sent.float() + r2, g.float() + r)


def test_randk_mask_stream():
    cfg = sp.parse_compress("randk:0.05")
    S = 100_000
    g = torch.from_numpy(_payload(S, 5)) + 10.0   # no zero payloads
    masks = {}
    for step in (0, 1):
        for bucket in (3, 4):
            s1, _, d1 = sp.compress_bucket(
                cfg, g, None, seed=sp.randk_seed(0, bucket, step))
            s2, _, _ = sp.compress_bucket(
                cfg, g, None, seed=sp.randk_seed(0, bucket, step))
            assert torch.equal(s1, s2)                 # deterministic
            kept = int((s1 != 0).sum())
            sigma = (S * 0.05 * 0.95) ** 0.5
            assert abs(kept - S * 0.05) < 4 * sigma, kept
            assert float(d1) == pytest.approx(kept / S, rel=1e-6)
            masks[step, bucket] = s1 != 0
    assert not torch.equal(masks[0, 3], masks[1, 3])   # across steps
    assert not torch.equal(masks[0, 3], masks[0, 4])   # across buckets
    assert sp.randk_seed(0, 3, 1) != sp.randk_seed(1, 3, 1)
    with pytest.raises(ValueError, match="seed"):
        sp.compress_bucket(cfg, g, None)


# ---------------------------------------------------------------------------
# the compressed bucket plan
# ---------------------------------------------------------------------------

def _qwen_shapes(dtype=None):
    """The reduced qwen2's per-device grad shapes (the reference's stacked
    layers), optionally all cast to ``dtype``."""
    cfg = ref_get_config("qwen2-0.5b").reduced()
    shapes = build_model(cfg, make_ctx(cfg, 1, 1)).abstract()[0]
    if dtype is not None:
        shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, dtype),
                              shapes)
    return shapes


def _leaves(shapes):
    return [(rbk.leaf_path_str(path), tuple(s.shape),
             TORCH_DTYPE[jnp.dtype(s.dtype)])
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 16, 1 << 20])
@pytest.mark.parametrize("spec", ["topk:0.01", "threshold:3.5:noef"])
def test_compressed_plan_equals_reference(bucket_bytes, spec):
    shapes = _qwen_shapes()
    tag = sp.parse_compress(spec).tag()
    ref = rbk.make_bucket_plan(
        shapes, lambda nm: nm in SPARSE_PATHS, bucket_bytes,
        lambda nm, leaf: "zen", compress=tag,
        compressed_scheme=lambda key, size: f"zen:{key}:{size}")
    got = bk.make_bucket_plan(
        _leaves(shapes), lambda nm: nm in SPARSE_PATHS, bucket_bytes,
        lambda nm, shape: "zen", compress=tag,
        compressed_scheme=lambda key, size: f"zen:{key}:{size}")
    got.validate()
    assert len(got.buckets) == len(ref.buckets)
    for gb, rb in zip(got.buckets, ref.buckets):
        assert (gb.bid, gb.kind, gb.scheme, gb.nbytes, gb.size, gb.key,
                gb.compress) == (rb.bid, rb.kind, rb.scheme, rb.nbytes,
                                 rb.size, rb.key, rb.compress)
        assert [(s.name, s.index, s.offset, s.size) for s in gb.slots] == \
            [(s.name, s.index, s.offset, s.size) for s in rb.slots]
        assert gb.compress == ("none" if gb.kind == bk.SPARSE else tag)
    bad = dataclasses.replace(got.buckets[0], compress=tag)
    with pytest.raises(ValueError, match="compressed"):
        dataclasses.replace(got, buckets=(bad, *got.buckets[1:])).validate()


# ---------------------------------------------------------------------------
# compressed GradSync against the reference
# ---------------------------------------------------------------------------

def _grads(leaves, seed):
    """{name: float32 numpy [N, ...]}: multiples of 1/8 in [-4, 4]; the
    embedding's rows kept with probability 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, _ in leaves:
        g = np.clip(np.round(rng.standard_normal((N, *shape)) * 8), -32,
                    32) / 8
        if name in SPARSE_PATHS:
            g *= (rng.random((N, shape[0])) < 0.1)[..., None]
        out[name] = g.astype(np.float32)
    return out


def _ref_sync(shapes, spec, scheme, bucket_bytes):
    """The reference GradSync and ``run(grads, residual, step)``: its call
    under ``jax.vmap`` over ``data``, jitted once (``step`` traced)."""
    gs = RefGradSync(RefSyncConfig(scheme=scheme, density_budget=0.25,
                                   bucket_bytes=bucket_bytes, compress=spec),
                     SPARSE_PATHS, shapes, N, data_axis="data")
    fn = jax.jit(jax.vmap(lambda g, r, t: gs(g, r, step=t),
                          in_axes=(0, 0, None), axis_name="data"))

    def run(grads, residual, step):
        tree = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(grads[rbk.leaf_path_str(p)]).astype(
                s.dtype), shapes)
        return fn(tree, residual, jnp.int32(step))
    return gs, run


def _port_gs(shapes, spec, scheme, bucket_bytes, ref_gs, backend="cuda"):
    gs = GradSync(SyncConfig(scheme=scheme, density_budget=0.25,
                             bucket_bytes=bucket_bytes, compress=spec,
                             backend=backend),
                  SPARSE_PATHS, _leaves(shapes), N)
    for key in list(gs._layouts):   # the reference's hash seeds
        lo = ref_gs._layouts[key]
        budget = (0.25 if key[0] in SPARSE_PATHS
                  else gs._compressed_budget())
        gs._layouts[key] = TS.make_zen_layout(
            lo.length, N, density_budget=budget, seeds=lo.seeds)
        assert gs._layouts[key].cap_index == lo.cap_index
    return gs


def _flat(tree):
    return {rbk.leaf_path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# (spec, leaf dtype): topk on the model's own dtypes (bf16 weights, f32
# norm scales), threshold on all-f32 leaves
REF_CASES = [("topk:0.01", None), ("threshold:3.5", jnp.float32)]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference GradSync's two steps per REF_CASES entry: outputs of
    each step, the residual threaded through."""
    out = {}
    for spec, dtype in REF_CASES:
        shapes = _qwen_shapes(dtype)
        gs, run = _ref_sync(shapes, spec, "zen", 1 << 20)
        res = {k: jnp.zeros((N, s), jnp.float32)
               for k, s in gs.compressed_buckets().items()}
        steps = []
        for step in range(2):
            synced, res, stats = run(_grads(_leaves(shapes), step), res,
                                     step)
            steps.append((_flat(synced), dict(res), stats))
        out[spec, dtype] = (shapes, gs, steps)
    return out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("spec,dtype", REF_CASES)
def test_compressed_gradsync_bitwise_reference(ref_runs, spec, dtype,
                                               backend):
    shapes, ref_gs, ref_steps = ref_runs[spec, dtype]
    gs = _port_gs(shapes, spec, "zen", 1 << 20, ref_gs, backend)
    assert gs.compressed_buckets() == ref_gs.compressed_buckets()
    assert gs.bucket_schemes() == ref_gs.bucket_schemes()
    leaves = _leaves(shapes)
    res = gs.init_residual("cpu")
    assert {k: tuple(v.shape) for k, v in res.items()} == \
        {k: (N, s) for k, s in ref_gs.compressed_buckets().items()}
    for step, (r_synced, r_res, r_stats) in enumerate(ref_steps):
        grads = _grads(leaves, step)
        synced, res, stats = gs({nm: torch.from_numpy(grads[nm]).to(dt)
                                 for nm, _, dt in leaves}, res, step=step)
        for nm, _, _ in leaves:
            _equal(synced[nm], r_synced[nm], f"step {step} {nm}")
        for k in r_res:
            _equal(res[k], r_res[k], f"step {step} residual {k}")
        assert set(stats) == set(r_stats)
        for k in r_stats:
            _equal(stats[k], r_stats[k], f"step {step} {k}")
    assert float(stats["sync/overflow"].sum()) == 0


@pytest.mark.parametrize("spec", ["topk:0.02", "randk:0.05"])
def test_compressed_zen_equals_compressed_dense(spec):
    """The wire scheme does not change what is synced: zen on the
    sparsified payloads == their psum (within 1e-5 at f32), and the EF
    residuals, computed before the wire, are bitwise equal."""
    shapes = _qwen_shapes(jnp.float32)
    leaves = _leaves(shapes)
    grads = {nm: torch.from_numpy(g)
             for nm, g in _grads(leaves, 0).items()}
    out = {}
    for scheme in ("zen", "dense"):
        gs = GradSync(SyncConfig(scheme=scheme, bucket_bytes=1 << 20,
                                 compress=spec), SPARSE_PATHS, leaves, N)
        out[scheme] = gs(grads, gs.init_residual("cpu"), step=3)
    for nm, _, _ in leaves:
        np.testing.assert_allclose(out["zen"][0][nm].numpy(),
                                   out["dense"][0][nm].numpy(), atol=1e-5)
    assert out["zen"][1].keys() == out["dense"][1].keys()
    for k in out["zen"][1]:
        assert torch.equal(out["zen"][1][k], out["dense"][1][k])
    assert float(out["zen"][2]["sync/overflow"].sum()) == 0


def test_compressed_wire_volume_beats_dense():
    """topk:0.01 + zen moves under 10 % of the dense buckets' words."""
    shapes = {"layers": {f"w{i:02d}": jax.ShapeDtypeStruct((1024,),
                                                           jnp.float32)
                         for i in range(16)}}
    leaves = _leaves(shapes)
    gs = GradSync(SyncConfig(scheme="zen", bucket_bytes=1 << 14,
                             compress="topk:0.01"), [], leaves, N)
    assert set(gs.bucket_schemes().values()) == {"zen"}
    grads = {nm: torch.from_numpy(g) for nm, g in _grads(leaves, 0).items()}
    _, _, stats = gs(grads, gs.init_residual("cpu"))
    dense_words = 2 * (N - 1) / N * 16 * 1024
    assert float(stats["sync/dense_words"].mean()) == 0.0
    assert float(stats["sync/sparse_sent_words"].mean()) < 0.10 * dense_words


def test_noef_keeps_no_state_and_ef_needs_residual():
    shapes = _qwen_shapes(jnp.float32)
    leaves = _leaves(shapes)
    grads = {nm: torch.from_numpy(g) for nm, g in _grads(leaves, 0).items()}
    gs = GradSync(SyncConfig(compress="topk:0.01:noef", bucket_bytes=1 << 20),
                  SPARSE_PATHS, leaves, N)
    assert gs.init_residual("cpu") == {}
    synced, nres, stats = gs(grads, {})
    assert nres == {}
    assert float(stats["sync/compressed_buckets"][0]) == len(
        gs.compressed_buckets())
    gs = GradSync(SyncConfig(compress="topk:0.01", bucket_bytes=1 << 20),
                  SPARSE_PATHS, leaves, N)
    with pytest.raises(ValueError, match="residual"):
        gs(grads)
    # donated: the new residual is written into the given tensors
    res = gs.init_residual("cpu")
    before = {k: v for k, v in res.items()}
    _, nres, _ = gs(grads, res, donate=True)
    assert all(nres[k] is before[k] for k in before)
    assert any(bool(v.abs().sum() > 0) for v in nres.values())


# ---------------------------------------------------------------------------
# 'auto' on compressed buckets, and the density controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_auto_compressed_gradsync_bitwise_reference(ref_runs, backend):
    """``--sync auto --compress topk:0.01``: the reference's auto plan puts
    zen on every compressed bucket (their worst case at density 0.01) and
    on the embedding, the plan of the reference's zen run; the port's auto
    GradSync plans the same, prints the same lines, and its two steps are
    bitwise that run's."""
    spec = "topk:0.01"
    shapes, ref_zen, ref_steps = ref_runs[spec, None]
    ref_auto = RefGradSync(RefSyncConfig(scheme="auto", density_budget=0.25,
                                         bucket_bytes=1 << 20, compress=spec),
                           SPARSE_PATHS, shapes, N, data_axis="data")
    assert ref_auto.bucket_schemes() == ref_zen.bucket_schemes()
    assert [b.scheme for b in ref_auto.plan.buckets] == \
        [b.scheme for b in ref_zen.plan.buckets]
    gs = _port_gs(shapes, spec, "auto", 1 << 20, ref_auto, backend)
    assert gs.describe() == ref_auto.describe()
    assert gs.bucket_schemes() == ref_auto.bucket_schemes()
    leaves = _leaves(shapes)
    res = gs.init_residual("cpu")
    for step, (r_synced, r_res, r_stats) in enumerate(ref_steps):
        grads = _grads(leaves, step)
        synced, res, stats = gs({nm: torch.from_numpy(grads[nm]).to(dt)
                                 for nm, _, dt in leaves}, res, step=step)
        for nm, _, _ in leaves:
            _equal(synced[nm], r_synced[nm], f"step {step} {nm}")
        for k in r_res:
            _equal(res[k], r_res[k], f"step {step} residual {k}")
        for k in r_stats:
            _equal(stats[k], r_stats[k], f"step {step} {k}")


@pytest.mark.parametrize("spec", ["topk:0.01", "randk:0.3", "threshold:0.5"])
@pytest.mark.parametrize("size,vw", [(896, 1), (1 << 20, 1), (151936, 896)])
def test_compress_and_measured_profiles_match_reference(spec, size, vw):
    tcfg, rcfg = sp.parse_compress(spec), rsp.parse_compress(spec)
    t = sp.compress_profile(tcfg, size, vw)
    r = rsp.compress_profile(rcfg, size, vw)
    for i in range(0, 10):
        assert t.d(i) == r.d(i)
    for n in (2, 4, 8):
        assert TC.choose_scheme(t, n) == rcm.choose_scheme(r, n)
        for d1, dn in ((0.01, 0.02), (0.3, 0.9), (0.7, 0.5), (-1, 2)):
            tm = sp.measured_profile(size, d1, dn, n, vw)
            rm = rsp.measured_profile(size, d1, dn, n, vw)
            for i in range(0, n + 3):
                assert tm.d(i) == rm.d(i) and tm.s(i) == rm.s(i)
            assert TC.choose_scheme(tm, n) == rcm.choose_scheme(rm, n)
            assert (tm.M, tm.vw) == (rm.M, rm.vw)


def _stats_for(key, d1, dn):
    return {sp.DENSITY1_KEY.format(key=key): d1,
            sp.DENSITYN_KEY.format(key=key): dn}


def _both_controllers(*args, **kwargs):
    return (sp.DensityController(*args, **kwargs),
            rsp.DensityController(*args, **kwargs))


def _same_step(t, r):
    assert t.schemes() == r.schemes()
    assert t.drifted() == r.drifted()
    return t.drifted()


def test_controller_flips_zen_to_dense_on_densification():
    t, r = _both_controllers({"a": 1 << 14}, {"a": "zen"}, n=2, ema=0.0)
    assert not _same_step(t, r)         # no observations: keep the plan
    for c in (t, r):
        c.observe(_stats_for("a", 0.02, 0.04))
    assert not _same_step(t, r)         # sparse: zen stays
    for c in (t, r):
        c.observe(_stats_for("a", 0.7, 1.0))
    assert _same_step(t, r) == {"a": ("zen", "dense")}
    for c in (t, r):
        c.rebase({"a": "dense"})
    assert not _same_step(t, r)
    # ...and back, when the measured density thins out again
    for c in (t, r):
        c.observe(_stats_for("a", 0.01, 0.02))
    assert _same_step(t, r) == {"a": ("dense", "zen")}


def test_controller_ema_smooths_single_outliers():
    t, r = _both_controllers({"a": 1 << 14}, {"a": "zen"}, n=2, ema=0.9)
    seq = ([(0.02, 0.04)] * 20 + [(0.9, 1.0)] + [(0.9, 1.0)] * 40)
    flips = []
    for step, (d1, dn) in enumerate(seq):
        for c in (t, r):
            c.observe(_stats_for("a", d1, dn))
        if _same_step(t, r):
            flips.append(step)
    assert 20 not in flips              # one outlier: the plan holds
    assert flips and flips[-1] == len(seq) - 1   # a sustained shift flips


def test_controller_on_many_buckets_and_tensor_metrics():
    """Several buckets, metrics as 0-d tensors beside unrelated keys, at
    n = 8, over a drifting sequence: the same picks every step."""
    sizes = {"b0": 896, "b1": 1 << 20, "b2": 13_074_432}
    t, r = _both_controllers(sizes, dict.fromkeys(sizes, "zen"), n=8)
    rng = np.random.default_rng(0)
    for step in range(30):
        stats = {"loss": 1.0}
        for k in sizes:
            d1 = float(rng.uniform(0.0, 0.2 + step / 40))
            stats.update(_stats_for(k, d1, min(1.0, d1 * rng.uniform(1, 8))))
        t.observe({k: torch.tensor(v) for k, v in stats.items()})
        r.observe(stats)
        _same_step(t, r)
        if step % 7 == 6:
            for c in (t, r):
                c.rebase(r.schemes())
    assert t.profiles().keys() == r.profiles().keys() == sizes.keys()


def test_controller_profiles_feed_gradsync_replan():
    """The full loop: a measured dense-ish profile makes 'auto' resolve
    that bucket to dense while an unmeasured one keeps zen (per bucket,
    not global); bucket keys and sizes are stable across the replan, as
    in the reference's GradSync given the same profiles."""
    shapes = {"layers": {"w00": jax.ShapeDtypeStruct((1024,), jnp.float32),
                         "w01": jax.ShapeDtypeStruct((1024,), jnp.float32)}}
    leaves = _leaves(shapes)
    cfg = dict(scheme="auto", density_budget=0.25, bucket_bytes=4096,
               compress="topk:0.05")
    gs0 = GradSync(SyncConfig(**cfg), [], leaves, 2)
    assert set(gs0.bucket_schemes().values()) == {"zen"}
    t, r = _both_controllers(gs0.compressed_buckets(), gs0.bucket_schemes(),
                             n=2, ema=0.0)
    key0 = next(iter(gs0.compressed_buckets()))
    for c in (t, r):
        c.observe(_stats_for(key0, 0.7, 1.0))
    assert _same_step(t, r)
    gs1 = GradSync(SyncConfig(**cfg), [], leaves, 2, profiles=t.profiles())
    ref1 = RefGradSync(RefSyncConfig(**cfg), [], shapes, 2,
                       data_axis="data", profiles=r.profiles())
    assert gs1.bucket_schemes() == ref1.bucket_schemes()
    assert gs1.bucket_schemes()[key0] == "dense"
    others = {k: v for k, v in gs1.bucket_schemes().items() if k != key0}
    assert others and set(others.values()) == {"zen"}
    assert gs1.compressed_buckets() == gs0.compressed_buckets()
    assert gs1.describe() == ref1.describe()
    # calibration (ROADMAP queue 1, item 7): the identity table re-plans
    # as no table does
    ident = sp.DensityController(gs0.compressed_buckets(),
                                 gs0.bucket_schemes(), 2, ema=0.0,
                                 calib=TC.CalibrationTable.identity())
    ident.observe(_stats_for(key0, 0.7, 1.0))
    assert ident.schemes() == t.schemes()
