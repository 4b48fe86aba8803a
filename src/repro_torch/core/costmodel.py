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

The measured-time calibration (DESIGN.md §11) is ported beside it:
``CalibrationTable`` (the reference's JSON format, version 2, and its
lookups term for term) and ``CostCalibrator``, which times the port's
own routes (backend ``"cuda"``: the kernels; ``"torch"``: their plain
versions).  A table keyed by the reference's backends (``"xla"``,
``"pallas"``) is refused on load, so that its times never price the
port's plans.  ``python -m repro_torch.core.costmodel --calib-file F``
writes a table and prints the flip points.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time
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
#
# The zenlint metadata is the reference's, scheme by scheme.
# lint_caps_fn sizes a stage so a FULLY DENSE [*, M] payload exactly
# saturates every buffer: that makes the SyncStats claim equal the wire
# bytes (R2's ==) for lint_saturable schemes.  Zen's buffers are
# r1_factor-overprovisioned by design (claim <= wire, never ==), so it is
# not saturable and lints at its working density instead.

_registry.register_scheme(
    "dense", "dense_sync", dense_allreduce, lambda n: 2.0 * (n - 1),
    plan_candidate=True,
    wire_words_fn=_wire_dense, expected_collectives=("all-reduce",),
    lint_saturable=True, lint_caps_fn=lambda M, n: {})
_registry.register_scheme(
    "zen", "zen_sync", zen, lambda n: 2.0 * (n - 1),
    stage_args=("layout", "use_hash_bitmap", "backend", "interpret", "fused",
                "fused_commit"),
    required_args=("layout",), plan_candidate=True,
    wire_words_fn=_wire_zen,
    expected_collectives=("all-to-all", "all-gather"),
    lint_saturable=False, lint_density=0.25,
    # the fused-commit kernels and the pre-fusion chain must satisfy the
    # same R1-R5 invariants with the same wire words (the compute route
    # may not change a single transmitted word)
    lint_routes=(("fused-commit", (("backend", "cuda"), ("fused", True),
                                   ("fused_commit", True))),
                 ("unfused", (("backend", "cuda"), ("fused", False),
                              ("fused_commit", False)))))
_registry.register_scheme(
    "agsparse", "agsparse_sync", agsparse, lambda n: float(n - 1),
    stage_args=("capacity", "backend"), required_args=("capacity",),
    plan_candidate=True,
    wire_words_fn=_wire_agsparse, expected_collectives=("all-gather",),
    lint_saturable=True, lint_caps_fn=lambda M, n: {"capacity": M})
_registry.register_scheme(
    "sparcml", "sparcml_sync", sparcml,
    lambda n: float(math.ceil(math.log2(max(n, 2)))),
    stage_args=("capacity", "backend"), required_args=("capacity",),
    needs_n=True, plan_candidate=True,
    feasible_fn=lambda n, M: n & (n - 1) == 0,
    wire_words_fn=_wire_sparcml,
    expected_collectives=("collective-permute",),
    lint_saturable=True, lint_caps_fn=lambda M, n: {"capacity": M})
_registry.register_scheme(
    "sparse_ps", "sparse_ps_sync", sparse_ps, lambda n: 2.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "backend"),
    required_args=(("cap_push", "capacity"), ("cap_pull", "capacity")),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    needs_n=True, feasible_fn=lambda n, M: M % n == 0,
    wire_words_fn=_wire_sparse_ps,
    expected_collectives=("all-to-all", "all-gather"),
    lint_saturable=True, lint_caps_fn=lambda M, n: {"capacity": M // n})
_registry.register_scheme(
    "omnireduce", "omnireduce_sync", omnireduce, lambda n: 2.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "block", "backend"),
    required_args=(("cap_push", "capacity"), ("cap_pull", "capacity")),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    arg_defaults=(("block", 8),), needs_n=True,
    wire_words_fn=_wire_omnireduce,
    expected_collectives=("all-to-all", "all-gather"),
    lint_saturable=True,
    lint_caps_fn=lambda M, n: {"block": 8, "capacity": M // n // 8})
_registry.register_scheme(
    "balanced", "balanced_sync", balanced, lambda n: 4.0 * (n - 1),
    stage_args=("capacity", "cap_push", "cap_pull", "bins", "backend"),
    required_args=(("cap_push", "capacity"),),
    arg_aliases=(("capacity", ("cap_push", "cap_pull")),),
    needs_n=True, plan_candidate=True,
    wire_words_fn=_wire_balanced,
    expected_collectives=("all-reduce", "all-to-all", "all-gather"),
    lint_saturable=True, lint_caps_fn=lambda M, n: {"capacity": M // n})
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


def choose_plan(
    p: SparsityProfile, topo: Topology, *, threshold: float = 1.0,
    calib: "CalibrationTable | None" = None,
) -> CommPlan:
    """argmin of the α-β plan times over the candidate set, biased toward
    dense: a non-dense plan wins only when its time beats the all-dense
    plan by ``threshold`` (ties resolve to dense via candidate order).
    This is where densify-after-intra-aggregation falls out: when the
    merged density ``d(n_intra)`` crosses the dense/sparse break-even on
    the inter links, ``hier(zen@intra, dense@inter)`` (or all-dense)
    times below ``hier(zen@intra, zen@inter)`` and wins.

    With a ``calib`` table (DESIGN.md §11) each candidate additionally
    pays its *measured* per-stage encode overhead
    (``plan_encode_overhead``); the identity table adds exactly 0.0, so
    the decision degenerates bitwise to the analytic argmin."""
    cands = candidate_plans(topo, p.M)

    def t(pl: CommPlan) -> float:
        tt = plan_time(pl, p, topo)
        if calib is not None:
            tt += plan_encode_overhead(calib, pl, p, topo)
        return tt

    times = {pl.tag(): t(pl) for pl in cands}
    dense_tag = cands[0].tag()
    best = min(cands, key=lambda pl: times[pl.tag()])
    if times[best.tag()] >= threshold * times[dense_tag]:
        return cands[0]
    return best


def choose_scheme(
    p: SparsityProfile, n: "int | Topology", *, threshold: float = 1.0,
    calib: "CalibrationTable | None" = None,
) -> str:
    """Per-tensor scheme choice from a (measured or worst-case) profile:
    'zen' iff its wire volume beats dense ring allreduce by ``threshold``.
    This is the decision the bucket planner applies tensor-by-tensor —
    scheme='auto' is per-leaf, never global (a high-density table falls
    back to dense without dragging genuinely sparse tables with it).

    With an ``int`` (or the degenerate flat topology) the decision is the
    historical volume comparison.  With a two-level ``Topology`` the
    returned tag is the α-β-optimal CommPlan's (``choose_plan``), e.g.
    ``hier(zen@intra,dense@inter)``.

    ``calib`` adds measured per-stage encode overhead to each side of the
    comparison: encode cost only ever flips zen -> dense (dense encodes
    for free), and ``calib=None`` / the identity table keep the analytic
    decision bit-identical."""
    if isinstance(n, Topology):
        topo = n
        if not topo.flat:
            return choose_plan(p, topo, threshold=threshold,
                               calib=calib).tag()
        lvl = topo.intra
        if lvl.size < 2:
            return "dense"
        zt = stage_time("zen", p, lvl)
        dt = stage_time("dense", p, lvl)
        if calib is not None:
            zt += (calib.encode_us("zen", p.M * p.vw, p.d(1))
                   + calib.commit_us("zen", p.M * p.vw, p.d(1)))
            dt += (calib.encode_us("dense", p.M * p.vw, p.d(1))
                   + calib.commit_us("dense", p.M * p.vw, p.d(1)))
        return "zen" if zt < threshold * dt else "dense"
    if n < 2:
        return "dense"  # single worker: nothing to sync, dense psum is free
    z, de = zen(p, n), dense_allreduce(p, n)
    if calib is not None:
        # words -> µs at the measured dense rate, then add measured encode
        # overhead; beta > 0 and identity (beta=1, encode=0) preserve the
        # analytic order/threshold exactly.
        b = calib.beta_us_per_word(p.M * p.vw)
        z = z * b + (calib.encode_us("zen", p.M * p.vw, p.d(1))
                     + calib.commit_us("zen", p.M * p.vw, p.d(1)))
        de = de * b + (calib.encode_us("dense", p.M * p.vw, p.d(1))
                       + calib.commit_us("dense", p.M * p.vw, p.d(1)))
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


# ---------------------------------------------------------------------------
# Measured-time calibration (DESIGN.md §11)
#
# The analytic α-β model prices the *wire*; it cannot see that zen's encode
# (hash + extract + pack) costs real device time while dense encodes for
# free.  A CalibrationTable holds measured per-stage times keyed by
# (backend, payload words, density); choose_scheme / choose_plan add the
# measured encode overhead to each candidate so the decision flips to dense
# exactly when encode cost eats the wire win.
# ---------------------------------------------------------------------------

# the reference's format: v2 measures commit_us directly (a commit-only
# probe over pre-computed encodes, per-worker share); other versions are
# rejected on load
_CALIB_VERSION = 2
# the port's routes: the CUDA kernels and their plain PyTorch versions.
# The reference's tables ("xla", "pallas") time other code on other
# hardware and are refused.
CALIB_BACKENDS = ("cuda", "torch")

# entry keys every table row carries:
#   backend    "cuda" | "torch"        compute route measured
#   size       int, payload FP32 words (M * vw)
#   density    float, d(1) measured at
#   n          int, sync-axis size of the measurement
#   encode_us  float, one zen_encode of one worker's payload
#   commit_us  float, one worker's zen_commit share, measured directly:
#              zen_commit over n pre-encoded workers / n
#   zen_us     float, full zen_sync end-to-end (n simulated workers)
#   dense_us   float, dense allreduce end-to-end (same rig)
# and, for a row-sparse point, rows and width (size = rows * width).


@dataclasses.dataclass
class CalibrationTable:
    """Measured per-stage sync times, persisted as JSON (``--calib-file``).

    Lookups are nearest-neighbor in (log size, log density) with encode
    time scaled linearly in payload size (encode work is O(nnz) ⊆ O(M)).
    The *identity* table (no entries) prices encode at 0 µs and the wire
    at 1 µs/word — choose_scheme / choose_plan then degenerate bitwise to
    the analytic α-β decision."""

    entries: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def identity(cls) -> "CalibrationTable":
        """Zero encode overhead, unit wire rate: the analytic model."""
        return cls(entries=[], meta={"identity": True})

    # --- persistence -------------------------------------------------------
    def save(self, path) -> None:
        blob = {"version": _CALIB_VERSION, "meta": self.meta,
                "entries": self.entries}
        with open(path, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "CalibrationTable":
        """Read a table :meth:`save` wrote; a wrong version, or an entry
        of a backend other than the port's, raises ``ValueError``."""
        with open(path) as f:
            blob = json.load(f)
        if blob.get("version") != _CALIB_VERSION:
            raise ValueError(
                f"calibration table {path}: version {blob.get('version')!r}"
                f" != {_CALIB_VERSION} (re-run the calibrator)")
        for e in blob["entries"]:
            if e.get("backend") not in CALIB_BACKENDS:
                raise ValueError(
                    f"calibration table {path}: an entry of backend "
                    f"{e.get('backend')!r}; the port prices its plans only "
                    f"from its own routes {CALIB_BACKENDS} (re-run "
                    f"`python -m repro_torch.core.costmodel`)")
        return cls(entries=blob["entries"], meta=blob.get("meta", {}))

    # --- lookups -----------------------------------------------------------
    def _nearest(self, size: float, density: float | None = None):
        if not self.entries:
            return None
        size = max(float(size), 1.0)

        def dist(e):
            ds = abs(math.log(max(e["size"], 1) / size))
            if density is None:
                return ds
            dd = abs(math.log(max(e["density"], 1e-9)
                              / max(density, 1e-9)))
            return ds + dd

        return min(self.entries, key=dist)

    def encode_us(self, scheme: str, size: float, density: float) -> float:
        """Measured local-encode overhead (µs) of ``scheme`` on a payload
        of ``size`` words at density ``density``.  Dense (a bare psum) and
        any unmeasured scheme encode for free; zen pays the nearest
        measurement scaled linearly in size."""
        if scheme != "zen":
            return 0.0
        e = self._nearest(size, density)
        if e is None:
            return 0.0
        return float(e["encode_us"]) * (max(float(size), 1.0)
                                        / max(e["size"], 1))

    def commit_us(self, scheme: str, size: float, density: float) -> float:
        """Measured per-worker commit overhead (µs): push + server
        aggregation + pull decode beyond the wire itself.  Dense commits
        for free (the psum IS the wire); zen pays the nearest direct
        commit-probe measurement scaled linearly in size."""
        if scheme != "zen":
            return 0.0
        e = self._nearest(size, density)
        if e is None:
            return 0.0
        return float(e.get("commit_us", 0.0)) * (max(float(size), 1.0)
                                                 / max(e["size"], 1))

    def beta_us_per_word(self, size: float) -> float:
        """Measured wire rate (µs per FP32 word) from the dense-allreduce
        measurement nearest in size; 1.0 (the analytic unit) when empty."""
        e = self._nearest(size)
        if e is None:
            return 1.0
        words = dense_allreduce(
            worst_case_profile(int(e["size"]), 1.0), int(e["n"]))
        return float(e["dense_us"]) / max(words, 1.0)


def plan_encode_overhead(
    calib: CalibrationTable, plan: CommPlan, p: SparsityProfile,
    topo: Topology,
) -> float:
    """Measured compute overhead (µs) a CommPlan pays beyond the wire:
    each non-trivial stage encodes its (merged) payload once before its
    collectives and pays its per-worker commit (server aggregation + pull
    decode) once after them."""
    t, k = 0.0, 1
    for stage in plan.stages:
        lvl = topo.levels[stage.level]
        if lvl.size > 1:
            mp = merged_profile(p, k)
            t += (calib.encode_us(stage.scheme, mp.M * mp.vw, mp.d(1))
                  + calib.commit_us(stage.scheme, mp.M * mp.vw, mp.d(1)))
        k *= lvl.size
    return t


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or
    ``"not read"`` where it cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else "not read"


class CostCalibrator:
    """Measures the port's encode / commit / dense times on this machine
    and returns a CalibrationTable (DESIGN.md §11).

    Per (size, density) point it times, on ``device``:
      * ``zen_encode`` of one worker's payload       -> encode_us
      * ``zen_commit`` over n PRE-ENCODED workers    -> commit_us (per
        worker: measured total / n — on a real mesh each device commits
        its share concurrently)
      * ``zen_sync`` over n workers on ``SimGroup``  -> zen_us
      * ``dense_sync`` over n workers on ``SimGroup`` -> dense_us
    each the min of ``iters`` runs after ``warmup``: CUDA events around
    the call on a CUDA device (host work that the card waits for
    included), the host clock on the CPU.  A size is a payload of that
    many f32 words (element-sparse, as the reference's), or a ``(rows,
    width)`` pair: a row-sparse table whose rows are live at the density
    (the entry's size is ``rows * width``).  On one card ``dense_us`` is
    the simulated group's in-process sum and measures no link.
    ``backend`` is the route: ``"cuda"`` the kernels, ``"torch"`` their
    plain versions."""

    def __init__(self, *, backend: str = "cuda", n: int = 4,
                 sizes: tuple = (1 << 12, 1 << 14, 1 << 16),
                 densities: tuple = (0.01, 0.1),
                 iters: int = 5, warmup: int = 2, seed: int = 0,
                 device=None):
        if n < 2:
            raise ValueError("CostCalibrator needs n >= 2 (a sync axis)")
        if backend not in CALIB_BACKENDS:
            raise ValueError(f"backend must be one of {CALIB_BACKENDS}, "
                             f"got {backend!r}")
        from repro_torch import resolve_device

        self.backend = backend
        self.n = n
        self.sizes = tuple(tuple(int(v) for v in s)
                           if isinstance(s, (tuple, list)) else int(s)
                           for s in sizes)
        self.densities = tuple(float(d) for d in densities)
        self.iters = iters
        self.warmup = warmup
        self.seed = seed
        self.device = resolve_device(device)

    def _time_us(self, fn, *args) -> float:
        """min-of-iters time of ``fn(*args)`` in µs after ``warmup``
        calls."""
        cuda = self.device.type == "cuda"
        for _ in range(self.warmup):
            fn(*args)
        if cuda:
            torch.cuda.synchronize(self.device)
        best = math.inf
        for _ in range(self.iters):
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                fn(*args)
                t1.record()
                t1.synchronize()
                best = min(best, t0.elapsed_time(t1) * 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                best = min(best, (time.perf_counter() - t0) * 1e6)
        return best

    def measure(self) -> CalibrationTable:
        from repro_torch.core import schemes

        entries = []
        dev, n, be = self.device, self.n, self.backend
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        for size in self.sizes:
            rows, width = size if isinstance(size, tuple) else (size, 1)
            for density in self.densities:
                budget = min(0.5, max(4.0 * density, 8.0 / rows))
                layout = schemes.make_zen_layout(rows, n,
                                                 density_budget=budget)
                # drawn on the device: a table's n payloads are GBs
                live = torch.rand((n, rows), generator=gen, device=dev)
                g = torch.randn((n, rows, width), generator=gen, device=dev)
                g = g * (live < density)[..., None]
                if width == 1:
                    g = g[..., 0]
                kw = dict(layout=layout, backend=be)
                encode_us = self._time_us(
                    lambda x: schemes.zen_encode(x, **kw), g[:1])
                # commit-only probe: encodes are made OUTSIDE the timed
                # function, so the measurement isolates push + aggregation
                # + pull decode (direct, not a residual)
                encs = schemes.zen_encode(g, **kw)
                group = schemes.SimGroup(n)
                commit_us = self._time_us(
                    lambda e, x: schemes.zen_commit(e, x, group=group, **kw),
                    encs, g) / n
                zen_us = self._time_us(
                    lambda x: schemes.zen_sync(x, group=group, **kw), g)
                dense_us = self._time_us(
                    lambda x: schemes.dense_sync(x, group=group), g)
                entry = {"backend": be, "size": rows * width,
                         "density": density, "n": n,
                         "encode_us": encode_us, "commit_us": commit_us,
                         "zen_us": zen_us, "dense_us": dense_us}
                if width > 1:
                    entry.update(rows=rows, width=width)
                entries.append(entry)
                del g, encs
        meta = {"backend": be, "n": n, "torch": torch.__version__,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
        if dev.type == "cuda":
            meta["power_limit"] = _power_limit()
        return CalibrationTable(entries=entries, meta=meta)


def flip_lines(table: CalibrationTable) -> list[str]:
    """One line an entry: its times and the analytic and measured
    decisions on the entry's worst-case profile, marked where they
    differ (the flip points)."""
    out = []
    for e in table.entries:
        p = worst_case_profile(e["size"], e["density"])
        analytic = choose_scheme(p, e["n"])
        measured = choose_scheme(p, e["n"], calib=table)
        flip = "  <- FLIP" if analytic != measured else ""
        out.append(f"  size={e['size']:>9} d={e['density']:<7.4g} "
                   f"encode={e['encode_us']:>9.1f}us "
                   f"commit={e['commit_us']:>9.1f}us "
                   f"zen={e['zen_us']:>9.1f}us "
                   f"dense={e['dense_us']:>9.1f}us analytic={analytic} "
                   f"measured={measured}{flip}")
    return out


def _main(argv=None) -> None:
    """``python -m repro_torch.core.costmodel``: run the calibrator,
    persist the table, and print where the measured decision differs from
    the analytic one (the flip points)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.core.costmodel",
        description="CostCalibrator: measure per-stage encode/commit/dense "
                    "times on this machine and write a --calib-file table "
                    "for launch/train.py")
    ap.add_argument("--calib-file", required=True)
    ap.add_argument("--backend", default="cuda", choices=CALIB_BACKENDS)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--sizes", default="4096,16384,65536",
                    help="comma-separated payload sizes (FP32 words)")
    ap.add_argument("--densities", default="0.01,0.1")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cal = CostCalibrator(
        backend=args.backend, n=args.n,
        sizes=tuple(int(s) for s in args.sizes.split(",")),
        densities=tuple(float(d) for d in args.densities.split(",")),
        iters=args.iters, device=args.device)
    table = cal.measure()
    table.save(args.calib_file)
    print(f"wrote {len(table.entries)} entries -> {args.calib_file} "
          f"(device: {table.meta['device']})")
    for line in flip_lines(table):
        print(line)


if __name__ == "__main__":
    _main()
