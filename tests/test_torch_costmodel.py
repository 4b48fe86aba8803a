"""Port parity: the scheme registry, the topology / CommPlan IR, the
sparsity metrics and the analytic cost model against the reference's
modules (``repro.core.registry``, ``topology``, ``metrics``,
``costmodel``), on one grid.

* the registry: the same scheme names in the same order, the same plan
  candidates (dense first, balanced last), the same ``--sync`` choices,
  the same stage-arg aliases, defaults and required groups, the same wire
  contracts at the same stage kwargs, a clean coverage check over the
  port's tests;
* the topology: ``build_topology``, ``parse_alpha_beta``, ``describe``,
  ``parse_plan`` / ``resolve_plan`` round trips and their errors;
* the metrics: every one bitwise on masks from the reference's
  ``synth_sparse_masks`` (the port draws the same masks from the integer
  seed the reference derives from its key);
* the cost model on flat topologies of n in {2, 4, 8}, two-level
  topologies (priced, not run) and densities 0.001-0.5, element- and
  row-sparse: ``choose_scheme`` / ``choose_plan`` picks and plan tags
  identical, ``plan_times``, ``normalized_times``, ``lower_bound``,
  ``candidate_plans`` and every scheme's volume equal as floats, on
  worst-case, merged and measured (``profile_from_masks``) profiles;
  ``calib=`` raises naming its ROADMAP item.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import costmodel as RC
from repro.core import metrics as RM
from repro.core import registry as RR
from repro.core import schemes as RS
from repro.core import topology as RT
from repro_torch.core import costmodel as TC
from repro_torch.core import metrics as TM
from repro_torch.core import registry as TR
from repro_torch.core import schemes as TS
from repro_torch.core import topology as TT

TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)
DENSITIES = [0.001, 0.005, 0.01, 0.03, 0.1, 0.25, 0.5]
FLAT_N = [2, 4, 8]
TWO_LEVEL = [(2, 2), (2, 4), (4, 2), (8, 1), (1, 8), (4, 4)]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_names_order_and_choices():
    assert TR.registered_schemes() == RR.registered_schemes()
    assert TR.registered_schemes(executable_only=True) == \
        RR.registered_schemes(executable_only=True)
    assert TR.plan_candidates() == RR.plan_candidates()
    assert TR.plan_candidates()[0] == "dense"
    assert TR.plan_candidates()[-1] == "balanced"
    assert TR.cli_scheme_choices() == RR.cli_scheme_choices()
    assert TR.BALANCED_BINS == RR.BALANCED_BINS


@pytest.mark.parametrize("name", RR.registered_schemes())
def test_registry_specs_match_reference(name):
    t, r = TR.get_scheme(name), RR.get_scheme(name)
    assert (t.sync_fn, t.required_args, t.arg_aliases, t.arg_defaults,
            t.needs_n, t.plan_candidate, t.executable) == \
        (r.sync_fn, r.required_args, r.arg_aliases, r.arg_defaults,
         r.needs_n, r.plan_candidate, r.executable)
    # the port's aggregating schemes also take their kernel route
    extra = set(t.stage_args) - set(r.stage_args)
    assert extra <= {"backend"} and set(r.stage_args) <= set(t.stage_args)
    for n in (1, 2, 3, 4, 6, 8):
        for m in (12, 16, 151936):
            assert t.feasible(n, m) == r.feasible(n, m), (n, m)
            assert t.rounds_fn(n) == r.rounds_fn(n)
    if t.executable:
        assert hasattr(TS, t.sync_fn) and t.resolve_sync() is getattr(
            TS, t.sync_fn)
    else:
        with pytest.raises(ValueError, match="analytic-only"):
            t.resolve_sync()


@pytest.mark.parametrize("name", RR.registered_schemes(executable_only=True))
@pytest.mark.parametrize("n", FLAT_N)
def test_wire_contracts_match_reference(name, n):
    M = 4096
    lo = RS.make_zen_layout(M, n, density_budget=0.1)
    targs = TS.stage_args_for(name, rows=M, budget=0.1, layout=lo)
    rargs = RS.stage_args_for(name, rows=M, budget=0.1, layout=lo)
    tkw = TR.stage_kwargs(TR.get_scheme(name), targs)
    rkw = RR.stage_kwargs(RR.get_scheme(name), rargs)
    tkw.pop("backend", None)
    rkw.pop("backend", None)
    assert tkw.keys() == rkw.keys()
    assert TR.get_scheme(name).wire_words_fn(M, n, tkw) == \
        RR.get_scheme(name).wire_words_fn(M, n, rkw)


def test_stage_args_aliases_and_set_fields():
    def kwargs(name, args):
        kw = TR.stage_kwargs(TR.get_scheme(name), args)
        assert kw.pop("backend") == args.backend   # the kernel route
        return kw

    assert kwargs("balanced", TR.StageArgs(capacity=128)) == \
        {"cap_push": 128, "cap_pull": 128}
    assert kwargs("balanced", TR.StageArgs(capacity=128, cap_pull=512,
                                           backend="cuda")) == \
        {"cap_push": 128, "cap_pull": 512}
    assert kwargs("omnireduce", TR.StageArgs(capacity=9)) == \
        {"cap_push": 9, "cap_pull": 9, "block": 8}
    assert TR.StageArgs(capacity=3, fused=True).set_fields() == \
        RR.StageArgs(capacity=3, fused=True).set_fields()
    with pytest.raises(ValueError, match="are not StageArgs fields"):
        TR.register_scheme("x", None, lambda p, n: 0.0, lambda n: 1.0,
                           stage_args=("nope",))


def test_registry_coverage_is_clean():
    assert TR.coverage_errors(TESTS_DIR) == []


# ---------------------------------------------------------------------------
# topology and plan tags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,node", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2)])
@pytest.mark.parametrize("ab", [None, "2,3e-4", "1,4e-5,10,4e-4"])
def test_build_topology_matches_reference(n, node, ab):
    if node == 1 and ab == "1,4e-5,10,4e-4":
        ab = "0.5,2"
    t = TT.build_topology(n, node, alpha_beta=ab)
    r = RT.build_topology(n, node, alpha_beta=ab)
    assert t.describe() == r.describe()
    assert (t.n, t.flat, t.axes) == (r.n, r.flat, r.axes)


@pytest.mark.parametrize("tag", [
    "zen", "dense", "agsparse", "sparcml", "sparse_ps", "omnireduce",
    "balanced", "hier(zen@intra,dense@inter)",
    "hier(balanced@intra,agsparse@inter)"])
def test_plan_tags_round_trip_and_resolve(tag):
    t, r = TT.parse_plan(tag), RT.parse_plan(tag)
    assert t.tag() == r.tag() == tag
    for topo_args in ((4, 1), (4, 2)):
        tt = TT.build_topology(*topo_args)
        rt = RT.build_topology(*topo_args)
        if len(t.stages) == 2 and tt.flat:
            with pytest.raises(ValueError, match="stages but the topology"):
                TT.resolve_plan(tag, tt)
            continue
        assert TT.resolve_plan(tag, tt).tag() == RT.resolve_plan(tag, rt).tag()


@pytest.mark.parametrize("tag,pattern", [
    ("lower_bound", "analytic-only"),
    ("balanced_parallelism", "analytic-only"),
    ("hier(balanced_parallelism@intra,dense@inter)", "analytic-only"),
    ("bogus", "registered schemes are"),
    ("zen@intra", "malformed"),
    ("hier(zen@intra)", "malformed"),
    ("hier(zen@inter,dense@intra)", "malformed"),
])
def test_plan_tag_errors_match_reference(tag, pattern):
    with pytest.raises(ValueError, match=pattern) as t:
        TT.parse_plan(tag)
    with pytest.raises(ValueError, match=pattern) as r:
        RT.parse_plan(tag)
    assert str(t.value).split(" (")[0] == str(r.value).split(" (")[0]


def test_topology_errors_match_reference():
    for bad in ("1,2,3", "x"):
        with pytest.raises(ValueError):
            TT.parse_alpha_beta(bad)
    with pytest.raises(ValueError, match="does not divide"):
        TT.build_topology(8, 3)
    with pytest.raises(ValueError, match="size must be"):
        TT.Level("a", 0)
    assert TT.parse_alpha_beta("1,2") == RT.parse_alpha_beta("1,2")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _masks(seed: int, n: int, m: int, density: float):
    """The reference's masks and the port's, drawn from the integer seed
    the reference derives from its key."""
    key = jax.random.PRNGKey(seed)
    ref = RM.synth_sparse_masks(key, n, m, density)
    s = int(np.asarray(jax.random.randint(key, (), 0, 2**31 - 1)))
    return ref, TM.synth_sparse_masks(s, n, m, density)


def _same(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("density", [0.01, 0.05, 0.3])
@pytest.mark.parametrize("n", FLAT_N)
def test_metrics_bitwise_reference(n, density):
    ref, got = _masks(n, n, 4096, density)
    _same(ref, got, "synth_sparse_masks")
    _same(RM.density(ref), TM.density(got), "density")
    _same(RM.density(ref[0]), TM.density(got[0]), "density row")
    _same(RM.overlap_ratio(ref[0], ref[-1]),
          TM.overlap_ratio(got[0], got[-1]), "overlap")
    _same(RM.aggregated_mask(ref), TM.aggregated_mask(got), "aggregated")
    _same(RM.densification_ratio(ref), TM.densification_ratio(got),
          "densification")
    for k in (1, 2, 4, 8, 64):
        _same(RM.skewness_ratio(ref[0], k), TM.skewness_ratio(got[0], k),
              f"skewness {k}")
    counts = np.random.default_rng(n).integers(0, 40, (n, n)).astype(np.int32)
    _same(RM.imbalance_ratio_push(jnp.asarray(counts)),
          TM.imbalance_ratio_push(torch.from_numpy(counts)), "push")
    _same(RM.imbalance_ratio_pull(jnp.asarray(counts[0])),
          TM.imbalance_ratio_pull(torch.from_numpy(counts[0])), "pull")


# ---------------------------------------------------------------------------
# the analytic cost model
# ---------------------------------------------------------------------------

def _profiles(M: int, density: float, vw: int):
    """(reference, port) pairs of the profiles the planner sees: the worst
    case of a budget, and its merge over 2 and 4 workers."""
    r = RC.worst_case_profile(M, density, vw=vw)
    t = TC.worst_case_profile(M, density, vw=vw)
    yield "worst", r, t
    for k in (2, 4):
        yield f"merged{k}", RC.merged_profile(r, k), TC.merged_profile(t, k)


def _topologies():
    for n in FLAT_N:
        yield f"flat{n}", RT.flat_topology(n), TT.flat_topology(n)
    for a, b in TWO_LEVEL:
        yield (f"two{a}x{b}", RT.two_level_topology(a, b),
               TT.two_level_topology(a, b))


@pytest.mark.parametrize("vw", [1, 896])
@pytest.mark.parametrize("density", DENSITIES)
def test_choose_and_times_identical_on_the_grid(density, vw):
    M = 151936 if vw > 1 else 1 << 20
    for pname, rp, tp in _profiles(M, density, vw):
        for n in FLAT_N:
            assert TC.choose_scheme(tp, n) == RC.choose_scheme(rp, n)
            for thr in (0.5, 0.9):
                assert TC.choose_scheme(tp, n, threshold=thr) == \
                    RC.choose_scheme(rp, n, threshold=thr)
            assert TC.lower_bound(tp, n) == RC.lower_bound(rp, n)
            for name in TC.SCHEMES:
                if name == "omnireduce":
                    continue   # needs block curves: measured profiles below
                assert TC.SCHEMES[name](tp, n) == RC.SCHEMES[name](rp, n)
            assert TC.zen_beats_dense(M, vw, n, density_budget=density) == \
                RC.zen_beats_dense(M, vw, n, density_budget=density)
        for tname, rt, tt in _topologies():
            what = f"{pname} {tname}"
            assert TC.choose_scheme(tp, tt) == RC.choose_scheme(rp, rt), what
            assert TC.choose_plan(tp, tt).tag() == \
                RC.choose_plan(rp, rt).tag(), what
            assert TC.plan_times(tp, tt) == RC.plan_times(rp, rt), what
            assert [p.tag() for p in TC.candidate_plans(tt, M)] == \
                [p.tag() for p in RC.candidate_plans(rt, M)], what
            assert TC.lower_bound(tp, tt) == RC.lower_bound(rp, rt), what
            if not rt.flat:   # plan tags only: no block curves needed
                assert TC.normalized_times(tp, tt) == \
                    RC.normalized_times(rp, rt), what


@pytest.mark.parametrize("n", FLAT_N)
@pytest.mark.parametrize("density", [0.002, 0.02, 0.2])
def test_profile_from_masks_matches_reference(n, density):
    """Measured curves: d(i), s(k), block density and the bottleneck
    partition's block fraction are the same floats, and so are every
    scheme's volume (omnireduce included) and the picks."""
    ref, got = _masks(7, n, 1 << 14, density)
    rp = RC.profile_from_masks(np.asarray(ref), block=64)
    tp = TC.profile_from_masks(got.numpy(), block=64)
    assert tp.M == rp.M and tp.block == rp.block
    for i in range(1, n + 2):
        assert tp.d(i) == rp.d(i)
        assert tp.block_density(i) == rp.block_density(i)
        for parts in (1, 2, 3, n):
            assert tp.block_max(i, parts) == rp.block_max(i, parts)
    for k in (1, 2, 3, 4, 8):
        assert tp.s(k) == rp.s(k)
    assert TC.normalized_times(tp, n) == RC.normalized_times(rp, n)
    assert TC.normalized_times(tp, TT.flat_topology(n)) == \
        RC.normalized_times(rp, RT.flat_topology(n))
    assert TC.choose_scheme(tp, n) == RC.choose_scheme(rp, n)
    for a, b in TWO_LEVEL:
        assert TC.plan_times(tp, TT.two_level_topology(a, b)) == \
            RC.plan_times(rp, RT.two_level_topology(a, b))


def test_worst_case_and_merged_profiles_match_reference():
    r = RC.worst_case_profile(1000, 0.07, vw=3)
    t = TC.worst_case_profile(1000, 0.07, vw=3)
    for k in (1, 2, 5):
        rm, tm = RC.merged_profile(r, k), TC.merged_profile(t, k)
        assert (tm.M, tm.vw, tm.block) == (rm.M, rm.vw, rm.block)
        for i in range(0, 20):
            assert tm.d(i) == rm.d(i) and tm.s(i + 1) == rm.s(i + 1)


def test_auto_picks_zen_at_the_qwen2_embedding_and_compressed_buckets():
    """The picks ``--sync auto`` makes at the qwen2-0.5b slice: zen for the
    embedding (M 151936, d 896) at budgets 0.25 / 0.05 / 0.01 at n = 8,
    and at 0.25 at n = 2 and 4, and for topk:0.01 compressed buckets of
    896, 13,074,432 and 136,134,656 elements at n = 8; the same as the
    reference's."""
    for n, budgets in ((8, (0.25, 0.05, 0.01)), (2, (0.25,)), (4, (0.25,))):
        for b in budgets:
            t = TC.worst_case_profile(151936, b, vw=896)
            r = RC.worst_case_profile(151936, b, vw=896)
            assert TC.choose_scheme(t, n) == RC.choose_scheme(r, n) == "zen"
    for size in (896, 13_074_432, 136_134_656):
        t = TC.worst_case_profile(size, 0.01)
        r = RC.worst_case_profile(size, 0.01)
        assert TC.choose_scheme(t, 8) == RC.choose_scheme(r, 8) == "zen"


def test_calibration_raises_naming_its_item(tmp_path):
    """Calibration (ROADMAP queue 1, item 7) is ported: ``calib=`` takes a
    table (the identity table keeps the analytic decision;
    tests/test_torch_calibration.py holds the rest), and what it refuses,
    a table of the reference's backends, raises naming the backend."""
    p = TC.worst_case_profile(1000, 0.1)
    ident = TC.CalibrationTable.identity()
    for fn, target in ((TC.choose_scheme, 4),
                       (TC.choose_plan, TT.two_level_topology(2, 2))):
        assert fn(p, target, calib=ident) == fn(p, target)
    path = tmp_path / "xla.json"
    RC.CalibrationTable(entries=[{"backend": "xla"}]).save(path)
    with pytest.raises(ValueError, match="backend 'xla'"):
        TC.CalibrationTable.load(path)
    assert math.isfinite(TC.plan_time(TT.flat_plan("zen"), p,
                                      TT.flat_topology(4)))
