"""Analytical communication-time models (§2.3.3, Fig. 7, Appendix B): the
analytic half of ``repro.core.costmodel``, ported.

Each model returns the per-GPU *receive volume in FP32 words*; communication
time is ``volume / B``.  Results are usually normalized to ``dense`` — the
ring-allreduce volume — reproducing Fig. 7's y-axis exactly.

Conventions (matching Appendix B):
  * COO transmits 2 words per non-zero (index + value).
  * ``d(i)`` is the density after aggregating tensors from ``i`` workers
    (``d(1) = d_G``); the densification curve comes either from measured masks
    (`profile_from_masks`) or an analytic overlap model.
  * ``s(i)`` is the skewness ratio with ``i`` partitions (Def. 5).

The measured-time calibration (``CalibrationTable``, ``CostCalibrator``)
is not ported: ROADMAP queue 1, item 7.  A ``calib`` argument other than
None raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable

import numpy as np

import torch

from repro_torch.core import metrics
from repro_torch.core import registry as _registry
from repro_torch.core.registry import BALANCED_BINS
from repro_torch.core.topology import (
    CommPlan,
    Level,
    Topology,
    flat_plan,
    hier_plan,
)


@dataclasses.dataclass(frozen=True)
class SparsityProfile:
    """Everything the cost models need to know about a workload's sparsity."""

    M: int                      # sparsity units (elements, or rows if vw > 1)
    d: Callable[[int], float]   # densification curve d(i), i >= 1
    s: Callable[[int], float]   # skewness curve s(n)
    block: int = 256            # OmniReduce block size
    block_density: Callable[[int], float] | None = None  # nonzero-block frac after i-agg
    # bottleneck partition's nonzero-block fraction (within that partition),
    # as a function of (i aggregated workers, n partitions)
    block_max: Callable[[int, int], float] | None = None
    # value width: FP32 words per sparsity unit — 1 for element-sparse (the
    # paper's setting), d for row-sparse embedding tables whose unit is an
    # embedding row.  COO then costs (1 + vw) words per non-zero and dense /
    # value-only terms scale by vw; every formula reduces to App. B at vw=1.
    vw: int = 1


def profile_from_masks(masks: np.ndarray, block: int = 256) -> SparsityProfile:
    """Measure d(i), s(n), and block density curves from [n, M] bool masks."""
    masks = np.asarray(masks)
    n, M = masks.shape
    d_curve = {}
    blk_curve = {}
    agg_cache = {}
    for i in range(1, n + 1):
        agg = masks[:i].any(axis=0)
        agg_cache[i] = agg
        d_curve[i] = float(agg.mean())
        nb = M // block
        blk = agg[: nb * block].reshape(nb, block).any(axis=1)
        blk_curve[i] = float(blk.mean())
    mask0 = masks[0]

    def block_max(i: int, parts: int) -> float:
        """Bottleneck partition's nonzero-block fraction (OmniReduce's
        aggregator hot spot)."""
        agg = agg_cache[min(max(i, 1), n)]
        nb = M // block
        blk = agg[: nb * block].reshape(nb, block).any(axis=1)
        kk = 1 << max(0, (parts - 1).bit_length())
        while nb % kk:
            kk //= 2
        per = blk.reshape(kk, nb // kk).mean(axis=1)
        return float(per.max())

    def s(k: int) -> float:
        kk = 1 << max(0, (k - 1).bit_length())  # nearest pow2 >= k
        while M % kk:
            kk //= 2
        return float(metrics.skewness_ratio(torch.from_numpy(mask0), kk))

    return SparsityProfile(
        M=M,
        d=lambda i: d_curve[min(max(i, 1), n)],
        s=s,
        block=block,
        block_density=lambda i: blk_curve[min(max(i, 1), n)],
        block_max=block_max,
    )


# --- volumes (FP32 words received per GPU) ---------------------------------
# Each formula is App. B with the COO word count 2 generalized to (1 + vw)
# and dense / value-only terms scaled by vw (see SparsityProfile.vw).

def dense_allreduce(p: SparsityProfile, n: int) -> float:
    """Ring allreduce: reduce-scatter + all-gather."""
    return 2 * (n - 1) / n * p.M * p.vw


def agsparse(p: SparsityProfile, n: int) -> float:
    """AllGather of COO sparse tensors (one-shot, centralization)."""
    return (1 + p.vw) * (n - 1) * p.d(1) * p.M


def sparcml(p: SparsityProfile, n: int) -> float:
    """SSAR_Recursive_double: log n stages of pairwise COO exchange with
    incremental aggregation; stage i exchanges density d(2^(i-1))."""
    stages = int(math.log2(n))
    return sum((1 + p.vw) * p.d(2 ** (i - 1)) * p.M
               for i in range(1, stages + 1))


def sparse_ps(p: SparsityProfile, n: int) -> float:
    """Even-range partitioning PS: skew-penalized push and pull (App. B.1):
    2 (n-1) s^n (d_G + d_G^n) M / n."""
    return (1 + p.vw) * (n - 1) * p.s(n) * (p.d(1) + p.d(n)) * p.M / n


def omnireduce(p: SparsityProfile, n: int) -> float:
    """Block-format PS. Non-zero blocks carry ``block`` values + 1 id word.
    The bottleneck aggregator receives the hottest partition's blocks from
    every worker (push) and broadcasts its aggregated blocks (pull)."""
    # wire words per gradient in a non-zero block
    w = (p.block * p.vw + 1) / p.block
    if p.block_max is not None:
        push = (n - 1) * p.block_max(1, n) * w * p.M / n
        pull = (n - 1) * p.block_max(n, n) * w * p.M / n
        return push + pull
    assert p.block_density is not None
    push = (n - 1) * p.s(n) * p.block_density(1) * w * p.M / n
    pull = (n - 1) * p.s(n) * p.block_density(n) * w * p.M / n
    return push + pull


def balanced_parallelism(p: SparsityProfile, n: int) -> float:
    """Theorem 1.2's optimal scheme with COO (skew = 1 by construction):
    2 (n-1)(d_G + d_G^n) M / n."""
    return (1 + p.vw) * (n - 1) * (p.d(1) + p.d(n)) * p.M / n


def balanced(p: SparsityProfile, n: int) -> float:
    """Executable Ok-Topk-style balanced split-and-exchange
    (``schemes.balanced_sync``): the histogram rebalance makes skew 1 by
    construction, so push + pull are exactly ``balanced_parallelism``'s
    optimal COO terms — note no ``s(n)`` factor, unlike ``sparse_ps`` —
    plus the B-bin boundary histogram's f32 allreduce."""
    bins = min(p.M, BALANCED_BINS)
    return balanced_parallelism(p, n) + 2 * (n - 1) / n * bins


def zen(p: SparsityProfile, n: int) -> float:
    """Balanced Parallelism + hash bitmap on Pull (§3.2.2):
    push COO (low density), pull values + M/32-word bitmap (Thm. 3)."""
    push = (1 + p.vw) * (n - 1) * p.d(1) * p.M / n
    pull = (n - 1) / n * (p.d(n) * p.M * p.vw + p.M / 32)
    return push + pull


def lower_bound(p: SparsityProfile, n: "int | Topology") -> float:
    """§4.1 footnote 3: receive the aggregated non-zeros of the other n-1
    workers, index-free: d_G^(n-1) M.  With a ``Topology`` the floor is
    β-weighted per level: every plan must move at least the flat floor's
    words over each level's links (see ``plan_times``)."""
    if isinstance(n, Topology):
        lb, k = 0.0, 1
        for lvl in n.levels:
            if lvl.size > 1:
                lb += lvl.beta * lower_bound(merged_profile(p, k), lvl.size)
            k *= lvl.size
        return lb
    return p.d(n - 1) * p.M * p.vw if n > 1 else 0.0


class _RegistryView(Mapping):
    """Live mapping {scheme name -> registered fn}: the historical
    ``SCHEMES`` / ``ROUNDS`` dict API, now backed by the scheme registry
    (single registration surface: core/registry.py)."""

    def __init__(self, attr: str):
        self._attr = attr

    def __getitem__(self, name: str) -> Callable:
        return getattr(_registry.get_scheme(name), self._attr)

    def __iter__(self):
        return iter(_registry.registered_schemes())

    def __len__(self) -> int:
        return len(_registry.registered_schemes())


# Volume formulas per scheme name (words received per GPU), and the
# message-round counts — the α (latency) term of the α-β link model.  A
# ring allreduce is 2(n-1) rounds; an all_gather ring n-1; a2a push +
# all_gather pull schemes pay both; recursive doubling log2 n; balanced
# additionally pays its histogram allreduce.  Both mappings are views
# over the registry (registrations at the bottom of this module).
SCHEMES: Mapping[str, Callable[[SparsityProfile, int], float]] = \
    _RegistryView("volume_fn")
ROUNDS: Mapping[str, Callable[[int], float]] = _RegistryView("rounds_fn")


# --- wire contracts ---------------------------------------------------------
# wire_words_fn(M, n, kw): the EXACT per-worker wire words a scheme's
# collectives carry at stage kwargs ``kw`` (value width 1): capacity-shaped,
# unlike volume_fn's density-shaped estimate.  They mirror the collectives
# in core/schemes.py op for op.

def _wire_dense(M: int, n: int, kw: dict) -> float:
    return 2.0 * (n - 1) / n * M


def _wire_zen(M: int, n: int, kw: dict) -> float:
    lo = kw["layout"]
    cp = lo.r1 + lo.r2  # a2a row width == pull compaction budget
    if kw.get("use_hash_bitmap", True):
        return float((n - 1) * (3 * cp + lo.cap_bitmap_words))
    return float((n - 1) * 4 * cp)


def _wire_agsparse(M: int, n: int, kw: dict) -> float:
    return 2.0 * (n - 1) * kw["capacity"]


def _wire_sparcml(M: int, n: int, kw: dict) -> float:
    return sum(2.0 * min(kw["capacity"] * (2 ** s) * 2, M)
               for s in range(int(math.log2(n))))


def _wire_sparse_ps(M: int, n: int, kw: dict) -> float:
    return 2.0 * (n - 1) * (kw["cap_push"] + kw["cap_pull"])


def _wire_omnireduce(M: int, n: int, kw: dict) -> float:
    return float((n - 1) * (kw["cap_push"] + kw["cap_pull"])
                 * (1 + kw["block"]))


def _wire_balanced(M: int, n: int, kw: dict) -> float:
    B = min(M, kw.get("bins") or BALANCED_BINS)
    cap_push = kw["cap_push"]
    cap_pull = kw.get("cap_pull") or cap_push
    return 2.0 * (n - 1) / n * B + 2.0 * (n - 1) * (cap_push + cap_pull)


# --- scheme registrations (the single surface) ------------------------------
# Order matters twice: ``plan_candidates`` keeps registration order, so
# dense must come first (argmin ties resolve dense) and balanced last
# (a new candidate must not steal exact ties from the historical set).
# ``sync_fn`` strings resolve lazily on repro_torch.core.schemes.  The
# aggregating schemes also consume ``backend``: their server aggregation
# runs on the scatter-add kernel (``"cuda"``) or its plain version.

_registry.register_scheme(
    "dense", "dense_sync", dense_allreduce, lambda n: 2.0 * (n - 1),
    plan_candidate=True, wire_words_fn=_wire_dense)
_registry.register_scheme(
    "zen", "zen_sync", zen, lambda n: 2.0 * (n - 1),
    stage_args=("layout", "use_hash_bitmap", "backend", "interpret", "fused",
                "fused_commit"),
    required_args=("layout",), plan_candidate=True,
    wire_words_fn=_wire_zen)
_registry.register_scheme(
    "agsparse", "agsparse_sync", agsparse, lambda n: float(n - 1),
    stage_args=("capacity", "backend"), required_args=("capacity",),
    plan_candidate=True, wire_words_fn=_wire_agsparse)
_registry.register_scheme(
    "sparcml", "sparcml_sync", sparcml,
    lambda n: float(math.ceil(math.log2(max(n, 2)))),
    stage_args=("capacity", "backend"), required_args=("capacity",),
    needs_n=True, plan_candidate=True,
    feasible_fn=lambda n, M: n & (n - 1) == 0,
    wire_words_fn=_wire_sparcml)
_registry.register_scheme(
    "sparse_ps", "sparse_ps_sync", sparse_ps, lambda n: 2.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "backend"),
    required_args=(("cap_push", "capacity"), ("cap_pull", "capacity")),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    needs_n=True, feasible_fn=lambda n, M: M % n == 0,
    wire_words_fn=_wire_sparse_ps)
_registry.register_scheme(
    "omnireduce", "omnireduce_sync", omnireduce, lambda n: 2.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "block", "backend"),
    required_args=(("cap_push", "capacity"), ("cap_pull", "capacity")),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    arg_defaults=(("block", 8),), needs_n=True,
    wire_words_fn=_wire_omnireduce)
_registry.register_scheme(
    "balanced", "balanced_sync", balanced, lambda n: 4.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "bins", "backend"),
    required_args=(("cap_push", "capacity"),),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    needs_n=True, plan_candidate=True, wire_words_fn=_wire_balanced)
# analytic-only curves (no executable collective): Fig. 7's optimum and
# the information-theoretic floor
_registry.register_scheme(
    "balanced_parallelism", None, balanced_parallelism,
    lambda n: 2.0 * (n - 1))
_registry.register_scheme(
    "lower_bound", None, lower_bound, lambda n: 1.0)


# ---------------------------------------------------------------------------
# α-β times over a Topology
# ---------------------------------------------------------------------------

def merged_profile(p: SparsityProfile, k: int) -> SparsityProfile:
    """The per-*node* profile after aggregating ``k`` workers inside a
    node: one node-level "worker" now carries density ``d(k)``, and i
    nodes together carry ``d(i*k)`` — the boundary semantics of the intra
    merge.  Skew and block curves shift the same way."""
    if k <= 1:
        return p
    return SparsityProfile(
        M=p.M,
        d=lambda i: p.d(max(i, 1) * k),
        s=p.s,
        block=p.block,
        block_density=(None if p.block_density is None
                       else (lambda i: p.block_density(max(i, 1) * k))),
        block_max=(None if p.block_max is None
                   else (lambda i, parts: p.block_max(max(i, 1) * k, parts))),
        vw=p.vw,
    )


def stage_time(scheme: str, p: SparsityProfile, level: Level) -> float:
    """α-β time (µs) of one plan stage: ``alpha * rounds + beta * words``.
    A size-1 level is free (nothing to synchronize)."""
    n = level.size
    if n <= 1:
        return 0.0
    return level.alpha * ROUNDS[scheme](n) + level.beta * SCHEMES[scheme](p, n)


def plan_time(plan: CommPlan, p: SparsityProfile, topo: Topology) -> float:
    """α-β time of a full CommPlan: stages run fastest level first, and
    each later stage sees the profile *merged* over every earlier level
    (capacity growth at the intra merge)."""
    t, k = 0.0, 1
    for stage in plan.stages:
        lvl = topo.levels[stage.level]
        t += stage_time(stage.scheme, merged_profile(p, k), lvl)
        k *= lvl.size
    return t


def _feasible(scheme: str, n: int, M: int) -> bool:
    """Whether a scheme can run at a level of size ``n`` (static shape /
    divisibility constraints, registered on each SchemeSpec)."""
    return _registry.get_scheme(scheme).feasible(n, M)


def candidate_plans(topo: Topology, M: int = 0) -> list[CommPlan]:
    """Every plan the planner considers, dense-first (so an argmin with
    ties resolves toward dense, matching ``choose_scheme``'s flat
    tie-break).  The candidate set is the registry's ``plan_candidate``
    schemes in registration order; sparse_ps / omnireduce register as
    non-candidates — they are the paper's imbalanced strawmen and carry
    divisibility constraints — so explicit tags can still request them,
    the planner just never picks them."""
    cands = _registry.plan_candidates()
    if topo.flat:
        n = topo.intra.size
        return [flat_plan(s) for s in cands if _feasible(s, n, M)]
    intra = [s for s in cands if _feasible(s, topo.intra.size, M)]
    inter = [s for s in cands if _feasible(s, topo.inter.size, M)]
    return [hier_plan(si, se) for si in intra for se in inter]


def plan_times(p: SparsityProfile, topo: Topology) -> dict[str, float]:
    """α-β time per candidate plan tag, plus the ``lower_bound`` floor
    (β-weighted per-level information minimum)."""
    out = {pl.tag(): plan_time(pl, p, topo) for pl in candidate_plans(topo, p.M)}
    out["lower_bound"] = lower_bound(p, topo)
    return out


def normalized_times(
    p: SparsityProfile, n: "int | Topology"
) -> dict[str, float]:
    """All schemes normalized to dense ring-allreduce (Fig. 7 y-axis).

    With an ``int`` (the historical signature) this is pure word volume.
    With a flat ``Topology`` the α-β times are normalized the same way —
    and on the *degenerate* topology (α=0, β=1) the result is exactly the
    int version.  With a two-level topology the keys are CommPlan tags
    (``hier(zen@intra,agsparse@inter)``, ...) normalized to the
    hierarchical dense plan."""
    if isinstance(n, Topology):
        topo = n
        if topo.flat:
            lvl = topo.intra
            base = stage_time("dense", p, lvl)
            return {name: stage_time(name, p, lvl) / base
                    for name in SCHEMES}
        times = plan_times(p, topo)
        base = times[hier_plan("dense", "dense").tag()]
        return {tag: t / base for tag, t in times.items()}
    base = dense_allreduce(p, n)
    return {name: fn(p, n) / base for name, fn in SCHEMES.items()}


# --- offline auto-scheme decision (runtime fallback, shared with Fig. 7) ----

def worst_case_profile(M: int, density: float, vw: int = 1) -> SparsityProfile:
    """Profile for a tensor whose per-step sparsity is only known by budget:
    no-overlap densification d(i) = min(i·d_G, 1) (the adversarial case for
    Zen's pull) and skew 1 (irrelevant to zen/dense)."""
    return SparsityProfile(
        M=M, d=lambda i: min(1.0, max(i, 1) * density), s=lambda n: 1.0, vw=vw)


def _no_calib(calib) -> None:
    if calib is not None:
        raise NotImplementedError(
            "measured-cost calibration (calib=) is not ported: ROADMAP "
            "queue 1, item 7")


def choose_plan(
    p: SparsityProfile, topo: Topology, *, threshold: float = 1.0,
    calib=None,
) -> CommPlan:
    """argmin of the α-β plan times over the candidate set, biased toward
    dense: a non-dense plan wins only when its time beats the all-dense
    plan by ``threshold`` (ties resolve to dense via candidate order).
    This is where densify-after-intra-aggregation falls out: when the
    merged density ``d(n_intra)`` crosses the dense/sparse break-even on
    the inter links, ``hier(zen@intra, dense@inter)`` (or all-dense)
    times below ``hier(zen@intra, zen@inter)`` and wins.  ``calib`` must
    be None (calibration: ROADMAP queue 1, item 7)."""
    _no_calib(calib)
    cands = candidate_plans(topo, p.M)
    times = {pl.tag(): plan_time(pl, p, topo) for pl in cands}
    dense_tag = cands[0].tag()
    best = min(cands, key=lambda pl: times[pl.tag()])
    if times[best.tag()] >= threshold * times[dense_tag]:
        return cands[0]
    return best


def choose_scheme(
    p: SparsityProfile, n: "int | Topology", *, threshold: float = 1.0,
    calib=None,
) -> str:
    """Per-tensor scheme choice from a (measured or worst-case) profile:
    'zen' iff its wire volume beats dense ring allreduce by ``threshold``.
    This is the decision the bucket planner applies tensor-by-tensor —
    scheme='auto' is per-leaf, never global (a high-density table falls
    back to dense without dragging genuinely sparse tables with it).

    With an ``int`` (or the degenerate flat topology) the decision is the
    historical volume comparison.  With a two-level ``Topology`` the
    returned tag is the α-β-optimal CommPlan's (``choose_plan``), e.g.
    ``hier(zen@intra,dense@inter)``.  ``calib`` must be None
    (calibration: ROADMAP queue 1, item 7)."""
    _no_calib(calib)
    if isinstance(n, Topology):
        topo = n
        if not topo.flat:
            return choose_plan(p, topo, threshold=threshold).tag()
        lvl = topo.intra
        if lvl.size < 2:
            return "dense"
        zt = stage_time("zen", p, lvl)
        dt = stage_time("dense", p, lvl)
        return "zen" if zt < threshold * dt else "dense"
    if n < 2:
        return "dense"  # single worker: nothing to sync, dense psum is free
    z, de = zen(p, n), dense_allreduce(p, n)
    return "zen" if z < threshold * de else "dense"


def zen_beats_dense(
    rows: int, d: int, n: int, *, density_budget: float,
    threshold: float = 1.0,
) -> bool:
    """The 'auto' scheme's per-leaf offline choice: sync a [rows, d] row-sparse
    leaf with Zen iff its worst-case wire volume beats dense ring allreduce by
    ``threshold``.  Built from the same ``zen`` / ``dense_allreduce`` formulas
    as the Fig. 7 analytics so the runtime fallback cannot drift from them.
    """
    p = worst_case_profile(rows, density_budget, vw=max(d, 1))
    return choose_scheme(p, n, threshold=threshold) == "zen"
