"""Port parity: ``zen_sync`` on the simulated group against the reference's
``schemes.simulate(schemes.zen_sync, ..., backend="xla")``, bitwise on the
synced values, the wire words and the overflow counts, plus GradSync; on
the fused route and on the unfused chains (``fused_encode=False`` and/or
``fused_commit=False``), which the reference's contract makes bitwise equal
to its "xla" route.

Inputs are integer-valued worker gradients (``_integer_workers`` of
tests/test_zen_commit_fused.py), so sums are exact in bf16 too; the hash
seeds are the reference layout's."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import metrics
from repro.core import schemes as S
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro_torch.core import schemes as TS
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.kernels import ops as tops

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ROUTES = [(False, True), (True, False), (False, False)]
ROUTE_IDS = ["encode-unfused", "commit-unfused", "both-unfused"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small ops: a pool of threads
    in each test worker only contends with the other workers' pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _integer_workers(seed, n, m, density, dtype, d=None):
    key = jax.random.PRNGKey(seed)
    masks = metrics.synth_sparse_masks(key, n, m, density)
    shape = (n, m) if d is None else (n, m, d)
    vals = jnp.round(jax.random.normal(key, shape) * 8)
    if d is not None:
        masks = masks[..., None]
    return (vals * masks).astype(dtype)


def _to_torch(x, td) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(td)


def _assert_sync_equal(got, ref):
    out, st = got
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref[0].astype(jnp.float32)))
    np.testing.assert_array_equal(st.sent_words.numpy(),
                                  np.asarray(ref[1].sent_words))
    np.testing.assert_array_equal(st.overflow.numpy(),
                                  np.asarray(ref[1].overflow))


# Each reference result below is computed once for the module, by one
# jitted program a layout (integer-valued sums are exact in any order), and
# shared by every case (and route) that holds the port to it.

N, MLEN = 4, 1 << 11


@functools.lru_cache(maxsize=None)
def _ref_zen(density_budget: float, r1_factor: float = 2.0,
             use_hash_bitmap: bool = True):
    """(the reference layout, its jitted ``simulate(zen_sync)``)."""
    lo = S.make_zen_layout(MLEN, N, density_budget=density_budget,
                           r1_factor=r1_factor)
    return lo, jax.jit(functools.partial(
        S.simulate, S.zen_sync, layout=lo, backend="xla",
        use_hash_bitmap=use_hash_bitmap))


@functools.lru_cache(maxsize=None)
def _sync_case(density, dtype, mode):
    """(reference result, port inputs, port layout) of one zen_sync case;
    one layout sized for density 1.0 serves every density."""
    d = None if mode == "element" else 8
    jd, td = DTYPES[dtype]
    vals = _integer_workers(2, N, MLEN, density, jd, d)
    lo, ref_fn = _ref_zen(1.0)
    tlo = TS.make_zen_layout(MLEN, N, density_budget=1.0, seeds=lo.seeds)
    return ref_fn(vals), _to_torch(vals, td), tlo


@functools.lru_cache(maxsize=None)
def _overflow_case(use_hash_bitmap):
    """(reference result, port inputs, port layout) at an undersized
    layout that overflows."""
    vals = _integer_workers(4, N, MLEN, 0.2, jnp.float32)
    lo, ref_fn = _ref_zen(0.05, 0.5, use_hash_bitmap)
    tlo = TS.make_zen_layout(MLEN, N, density_budget=0.05, r1_factor=0.5,
                             seeds=lo.seeds)
    return ref_fn(vals), _to_torch(vals, torch.float32), tlo


@pytest.mark.parametrize("mode", ["element", "row"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("density", [0.01, 0.1, 1.0])
def test_zen_sync_bitwise_vs_reference(density, dtype, mode):
    """One layout sized for density 1.0 serves every density, so the
    reference compiles once per (dtype, mode)."""
    ref, tv, tlo = _sync_case(density, dtype, mode)
    for backend in ("torch", "cuda"):   # "cuda" on CPU tensors: plain route
        got = TS.simulate(TS.zen_sync, tv, layout=tlo, backend=backend)
        assert got[0].dtype == DTYPES[dtype][1]
        _assert_sync_equal(got, ref)


@pytest.mark.parametrize("use_hash_bitmap", [True, False],
                         ids=["bitmap-pull", "coo-pull"])
def test_zen_sync_overflow_edge_and_coo_pull(use_hash_bitmap):
    """An undersized layout (tiny r1/r2) overflows: the port must drop the
    same rows and count the same overflow; the COO-pull ablation changes
    the wire words only."""
    ref, tv, tlo = _overflow_case(use_hash_bitmap)
    assert int(np.asarray(ref[1].overflow).sum()) > 0
    got = TS.simulate(TS.zen_sync, tv, layout=tlo,
                      use_hash_bitmap=use_hash_bitmap)
    _assert_sync_equal(got, ref)


def test_dense_sync_matches_reference():
    n, m = 4, 300
    vals = _integer_workers(1, n, m, 0.3, jnp.float32, 3)
    ref = S.simulate(S.dense_sync, vals)
    got = TS.simulate(TS.dense_sync, _to_torch(vals, torch.float32))
    _assert_sync_equal(got, ref)


GRADSYNC_SCHEMES = ["zen", "dense", "agsparse", "sparcml", "sparse_ps",
                    "omnireduce", "balanced", "auto"]
GS_SHAPES = {"embed": {"table": jax.ShapeDtypeStruct((512, 8), jnp.float32)},
             "w": jax.ShapeDtypeStruct((6, 5), jnp.float32)}


@functools.lru_cache(maxsize=None)
def _gs_inputs(step: int) -> tuple[np.ndarray, np.ndarray]:
    """Step ``step``'s worker gradients of the GradSync cases: the
    row-sparse embedding and the dense leaf."""
    rng = np.random.default_rng(0)
    for _ in range(step + 1):
        dense = np.round(rng.standard_normal((4, 6, 5)) * 8).astype(
            np.float32)
    return (np.array(_integer_workers(3 + step, 4, 512, 0.05, jnp.float32,
                                      8)), dense)


@functools.lru_cache(maxsize=None)
def _ref_gradsync(scheme: str):
    """The reference GradSync of ``scheme`` over the 4 workers, and its
    result on each step's inputs (vmapped, one jitted program)."""
    ref_gs = RefGradSync(RefSyncConfig(scheme=scheme), ["embed/table"],
                         GS_SHAPES, 4)
    fn = jax.jit(jax.vmap(ref_gs, axis_name="data"))
    outs = []
    for step in range(2):
        emb, dense = _gs_inputs(step)
        outs.append(fn({"embed": {"table": jnp.asarray(emb)},
                        "w": jnp.asarray(dense)}))
    return ref_gs, outs


@pytest.mark.parametrize("scheme", GRADSYNC_SCHEMES)
def test_gradsync_matches_reference(scheme):
    """GradSync over a small model-shaped pytree: the scheme (or a psum,
    or 'auto's per-leaf pick) on the row-sparse embedding, psum on the
    rest, mean over 4 workers, two steps (the second on other grads): the
    synced grads, the sync metrics and the describe() lines equal the
    reference's, on both routes."""
    n = 4
    ref_gs, ref_outs = _ref_gradsync(scheme)
    leaves = [("embed/table", (512, 8), torch.float32),
              ("w", (6, 5), torch.float32)]
    ports = {}
    for backend in ("torch", "cuda"):
        gs = GradSync(SyncConfig(scheme=scheme, backend=backend),
                      ["embed/table"], leaves, n)
        assert gs.describe() == ref_gs.describe()
        if ("embed/table", 0) in gs._layouts:   # the reference's seeds
            lo = ref_gs._layouts["embed/table", 0]
            gs._layouts["embed/table", 0] = TS.make_zen_layout(
                512, n, density_budget=0.25, seeds=lo.seeds)
        ports[backend] = gs
    for step in range(2):
        emb, dense = _gs_inputs(step)
        ref_out, ref_st = ref_outs[step]
        for backend, gs in ports.items():
            out, st = gs({"embed/table": torch.from_numpy(emb),
                          "w": torch.from_numpy(dense)})
            np.testing.assert_array_equal(
                out["embed/table"].numpy(),
                np.asarray(ref_out["embed"]["table"]))
            np.testing.assert_array_equal(out["w"].numpy(),
                                          np.asarray(ref_out["w"]))
            assert set(st) == set(ref_st)
            for k in ref_st:
                np.testing.assert_array_equal(
                    st[k].numpy(), np.asarray(ref_st[k]),
                    err_msg=f"{scheme} {backend} step {step} {k}")


def test_gradsync_rejects_unported_settings():
    """Calibration (item 7) takes a table file, and one that is not there
    raises (the launcher writes it first: tests/test_torch_calibration.py);
    an α-β override is accepted (the trainer's topology reads it:
    tests/test_torch_hier.py); every registry scheme and 'auto' build and
    run."""
    leaves = [("embed/table", (64, 4), torch.float32)]
    with pytest.raises(FileNotFoundError):
        GradSync(SyncConfig(calib_file="no-such-calib.json"),
                 ["embed/table"], leaves, 4)
    assert GradSync(SyncConfig(alpha_beta="1,1"), ["embed/table"], leaves,
                    4).topology.flat
    g = torch.zeros((4, 64, 4))
    g[:, :8] = 1.0
    for scheme in ("agsparse", "auto"):
        gs = GradSync(SyncConfig(scheme=scheme), ["embed/table"], leaves, 4)
        out, st = gs({"embed/table": g})
        assert torch.equal(out["embed/table"], g)
        assert not st["sync/overflow"].any()
    # 'auto' picks per leaf by the cost model: zen at this budget
    assert GradSync(SyncConfig(scheme="auto"), ["embed/table"], leaves,
                    4).plan.buckets[0].scheme == "zen"
    with pytest.raises(ValueError, match="registered schemes are"):
        GradSync(SyncConfig(scheme="bogus"), ["embed/table"], leaves, 4)
    # EF compression is ported (tests/test_torch_sparsify.py)
    assert GradSync(SyncConfig(compress="topk:0.01"), ["embed/table"],
                    leaves, 4).has_compression
    # the unfused chains run (tests/test_torch_unfused_chain.py holds them
    # against the reference)
    for cfg in (SyncConfig(fused_commit=False), SyncConfig(fused_encode=False)):
        out, st = GradSync(cfg, ["embed/table"], leaves, 4)({"embed/table": g})
        assert torch.equal(out["embed/table"], g)
        assert not st["sync/overflow"].any()


# ---------------------------------------------------------------------------
# the unfused routes (fused_encode=False and/or fused_commit=False): the same
# cases and reference programs as above
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,fused_commit", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("mode", ["element", "row"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("density", [0.01, 1.0])
def test_zen_sync_unfused_bitwise_vs_reference(density, dtype, mode, fused,
                                               fused_commit):
    ref, tv, tlo = _sync_case(density, dtype, mode)
    for backend in ("torch", "cuda"):   # "cuda" on CPU tensors: plain route
        tops.reset_counts()
        got = TS.simulate(TS.zen_sync, tv, layout=tlo, backend=backend,
                          fused=fused, fused_commit=fused_commit)
        assert got[0].dtype == tv.dtype
        _assert_sync_equal(got, ref)
        want = dict.fromkeys(tops.KERNELS, 0)
        if backend == "cuda":
            want.update(tops.path_launches(N, fused, fused_commit))
        assert tops.PLAIN_CALLS == want


def test_zen_sync_unfused_encode_vs_reference_pallas_route():
    """The reference's own unfused encode (interpret-mode hash-stage and
    row-compaction kernels) gives the port's bits too."""
    vals = _integer_workers(6, N, 1 << 10, 0.02, jnp.float32, 4)
    lo = S.make_zen_layout(1 << 10, N, density_budget=0.05)
    ref = S.simulate(S.zen_sync, vals, layout=lo, backend="pallas",
                     fused=False)
    tlo = TS.make_zen_layout(1 << 10, N, density_budget=0.05, seeds=lo.seeds)
    got = TS.simulate(TS.zen_sync, _to_torch(vals, torch.float32), layout=tlo,
                      backend="cuda", fused=False, fused_commit=False)
    _assert_sync_equal(got, ref)


@pytest.mark.parametrize("fused,fused_commit", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("use_hash_bitmap", [True, False],
                         ids=["bitmap-pull", "coo-pull"])
def test_zen_sync_unfused_overflow_edge_and_coo_pull(use_hash_bitmap, fused,
                                                     fused_commit):
    ref, tv, tlo = _overflow_case(use_hash_bitmap)
    assert int(np.asarray(ref[1].overflow).sum()) > 0
    tops.reset_counts()
    got = TS.simulate(TS.zen_sync, tv,
                      layout=tlo, use_hash_bitmap=use_hash_bitmap,
                      backend="cuda", fused=fused, fused_commit=fused_commit)
    _assert_sync_equal(got, ref)
    ran = {k for k, v in tops.PLAIN_CALLS.items() if v}
    assert ran == set(tops.path_kernels(fused, fused_commit, use_hash_bitmap))


@pytest.mark.parametrize("fused_encode,fused_commit", ROUTES, ids=ROUTE_IDS)
def test_gradsync_unfused_matches_reference(fused_encode, fused_commit):
    """GradSync with the unfused chain(s) on the row-sparse embedding vs
    the reference GradSync on its "xla" route, bitwise."""
    n = 4
    emb, dense = _gs_inputs(0)
    ref_gs, ref_outs = _ref_gradsync("zen")   # the default scheme
    assert RefSyncConfig().scheme == "zen"
    ref_out, ref_st = ref_outs[0]
    cfg = SyncConfig(fused_encode=fused_encode, fused_commit=fused_commit)
    gs = GradSync(cfg, ["embed/table"],
                  [("embed/table", (512, 8), torch.float32),
                   ("w", (6, 5), torch.float32)], n)
    lo = ref_gs._layouts["embed/table", 0]
    gs._layouts["embed/table", 0] = TS.make_zen_layout(
        512, n, density_budget=0.25, seeds=lo.seeds)
    tops.reset_counts()
    out, st = gs({"embed/table": torch.from_numpy(emb),
                  "w": torch.from_numpy(dense)})
    np.testing.assert_array_equal(out["embed/table"].numpy(),
                                  np.asarray(ref_out["embed"]["table"]))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref_out["w"]))
    for k in ("sync/sparse_sent_words", "sync/overflow"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(ref_st[k]),
                                      err_msg=k)
    ran = {k for k, v in tops.PLAIN_CALLS.items() if v}
    assert ran == set(tops.path_kernels(fused_encode, fused_commit))
