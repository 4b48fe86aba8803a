"""Topology + CommPlan IR: the shape of the data-parallel world (a copy of
``repro.core.topology`` for the port).

The winning communication scheme flips with topology (OkTopk's
near-optimal sparse allreduce; S-SGD's DAG α-β model), so the sync stack
plans against two small IR pieces:

* ``Topology`` — an ordered list of ``Level``s, **fastest first**: each
  level is a mesh/vmap axis name, its size, and the α-β parameters of the
  links at that level (``alpha`` = per-message-round latency in µs,
  ``beta`` = µs per FP32 word).  A flat world is a one-level topology; a
  ``--node-size k`` world is ``(dp_intra: k, dp_inter: n/k)``.  The
  **degenerate** flat topology uses ``alpha=0, beta=1`` so α-β *time*
  reduces exactly to word *volume* — the pre-topology cost model — and
  every scheme pick is bit-identical to the flat stack.

* ``CommPlan`` — what a bucket executes: an ordered list of ``Stage``s
  (scheme, level), run fastest-level first.  Aggregation over the
  data-parallel product axis is associative, so
  ``sum_all == sum_inter(sum_intra)`` and any per-level scheme
  composition is exact.  Grammar (round-trippable via ``parse_plan``):

      plan  := scheme                          -- flat, one stage
             | "hier(" scheme "@intra," scheme "@inter" ")"

  A flat plan's tag is just the scheme name, so ``Bucket.scheme`` tags
  from the flat era parse unchanged (plan-stable identity).

Pure Python: built offline, consumed by ``core/costmodel.py`` (α-β times),
``core/schemes.py`` (``hier_sync``), ``core/zen.py`` (each bucket's plan
and per-level layouts) and ``launch/mesh.py`` (the level groups).
"""
from __future__ import annotations

import dataclasses
import math

# Mesh/vmap axis names of a node-split data-parallel world.  ``dp_intra``
# indexes devices within a node (fast links), ``dp_inter`` indexes nodes
# (slow links).  The flat world keeps its historical single "data" axis.
DP_INTRA = "dp_intra"
DP_INTER = "dp_inter"

# Default α-β link parameters (µs, µs per FP32 word), the reference's.
# Within a node: NVLink-class, ~100 GB/s per link.  Across nodes:
# ~10 GB/s.  These are planning defaults, not measurements — override
# with ``parse_alpha_beta``.
ALPHA_INTRA = 1.0
BETA_INTRA = 4e-5      # 4 B / 1e11 B/s = 4e-5 µs/word
ALPHA_INTER = 10.0
BETA_INTER = 4e-4      # 4 B / 1e10 B/s


@dataclasses.dataclass(frozen=True)
class Level:
    """One rung of the topology: an axis of ``size`` peers whose links
    have latency ``alpha`` (µs/round) and inverse bandwidth ``beta``
    (µs per FP32 word)."""

    axis: str
    size: int
    alpha: float = 0.0
    beta: float = 1.0

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"level {self.axis!r}: size must be >= 1, "
                             f"got {self.size}")
        if self.alpha < 0 or self.beta <= 0:
            raise ValueError(f"level {self.axis!r}: need alpha >= 0 and "
                             f"beta > 0, got α={self.alpha} β={self.beta}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Ordered levels, fastest (innermost) first."""

    levels: tuple[Level, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("topology needs at least one level")
        if len(self.levels) > 2:
            raise ValueError(
                f"only one- and two-level topologies are supported, got "
                f"{len(self.levels)} levels")
        names = [lv.axis for lv in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level axes: {names}")

    @property
    def n(self) -> int:
        """Total data-parallel world size (product of level sizes)."""
        return math.prod(lv.size for lv in self.levels)

    @property
    def flat(self) -> bool:
        return len(self.levels) == 1

    @property
    def intra(self) -> Level:
        return self.levels[0]

    @property
    def inter(self) -> Level:
        return self.levels[-1]

    @property
    def axes(self) -> tuple[str, ...]:
        """Level axis names fastest-first — note mesh construction orders
        them slowest-first (outer mesh dims vary slowest)."""
        return tuple(lv.axis for lv in self.levels)

    def describe(self) -> str:
        return " > ".join(
            f"{lv.axis}[{lv.size}] α={lv.alpha:g}µs β={lv.beta:g}µs/w"
            for lv in reversed(self.levels))


def flat_topology(n: int, axis: str = "data",
                  alpha: float = 0.0, beta: float = 1.0) -> Topology:
    """One-level topology.  The default (α=0, β=1) is the **degenerate**
    topology: α-β time == word volume, so cost-model behavior is exactly
    the historical flat stack."""
    return Topology((Level(axis=axis, size=n, alpha=alpha, beta=beta),))


def two_level_topology(
    n_intra: int, n_inter: int, *,
    intra_axis: str = DP_INTRA, inter_axis: str = DP_INTER,
    alpha_intra: float = ALPHA_INTRA, beta_intra: float = BETA_INTRA,
    alpha_inter: float = ALPHA_INTER, beta_inter: float = BETA_INTER,
) -> Topology:
    return Topology((
        Level(axis=intra_axis, size=n_intra,
              alpha=alpha_intra, beta=beta_intra),
        Level(axis=inter_axis, size=n_inter,
              alpha=alpha_inter, beta=beta_inter),
    ))


def parse_alpha_beta(spec: str | None) -> dict:
    """Parse an ``--alpha-beta`` override.

    ``"a_intra,b_intra,a_inter,b_inter"`` (µs, µs/word) for two-level
    topologies; ``"a,b"`` applies one pair to every level.  ``None`` / ""
    means the defaults.  Returns kwargs for ``two_level_topology``."""
    if not spec:
        return {}
    parts = [float(x) for x in str(spec).split(",")]
    if len(parts) == 2:
        a, b = parts
        return dict(alpha_intra=a, beta_intra=b,
                    alpha_inter=a, beta_inter=b)
    if len(parts) == 4:
        return dict(alpha_intra=parts[0], beta_intra=parts[1],
                    alpha_inter=parts[2], beta_inter=parts[3])
    raise ValueError(
        f"--alpha-beta wants 'alpha,beta' or "
        f"'a_intra,b_intra,a_inter,b_inter', got {spec!r}")


def build_topology(n: int, node_size: int = 1, *, axis: str = "data",
                   alpha_beta: str | None = None) -> Topology:
    """The launcher's topology constructor.

    ``node_size == 1`` returns the degenerate flat topology over the
    historical ``axis`` — every downstream decision is then bit-identical
    to the pre-topology stack.  ``node_size > 1`` splits the ``n``-way
    data-parallel world into ``n // node_size`` nodes of ``node_size``
    devices with the default (or overridden) α-β link parameters.
    ``node_size == n`` is a single node — still two-level, with a
    size-1 (free) inter level, so the code path is uniform."""
    if node_size <= 1:
        if alpha_beta:
            a, b = (parse_alpha_beta(alpha_beta)["alpha_intra"],
                    parse_alpha_beta(alpha_beta)["beta_intra"])
            return flat_topology(n, axis=axis, alpha=a, beta=b)
        return flat_topology(n, axis=axis)
    if n % node_size != 0:
        raise ValueError(
            f"node_size={node_size} does not divide the data-parallel "
            f"world n={n}; pick a divisor of {n}")
    return two_level_topology(node_size, n // node_size,
                              **parse_alpha_beta(alpha_beta))


# ---------------------------------------------------------------------------
# CommPlan
# ---------------------------------------------------------------------------

# role names used by the plan grammar, indexed by level position
_ROLES = ("intra", "inter")


@dataclasses.dataclass(frozen=True)
class Stage:
    """One plan step: run ``scheme`` over topology level ``level``."""

    scheme: str
    level: int


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """An executable composition of per-level scheme stages, fastest
    level first.  ``hier_sync`` (core/schemes.py) interprets it."""

    stages: tuple[Stage, ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("a CommPlan needs at least one stage")
        if [s.level for s in self.stages] != list(range(len(self.stages))):
            raise ValueError(
                f"stages must cover levels 0..k in order, got "
                f"{[s.level for s in self.stages]}")

    @property
    def flat(self) -> bool:
        return len(self.stages) == 1

    def tag(self) -> str:
        """Round-trippable plan tag.  Flat plans keep the bare scheme
        name — byte-identical to the pre-topology ``Bucket.scheme`` tags,
        so bucket identity survives the IR refactor."""
        if self.flat:
            return self.stages[0].scheme
        inner = ",".join(f"{s.scheme}@{_ROLES[s.level]}" for s in self.stages)
        return f"hier({inner})"

    def scheme_at(self, level: int) -> str:
        return self.stages[level].scheme


def flat_plan(scheme: str) -> CommPlan:
    return CommPlan((Stage(scheme, 0),))


def hier_plan(intra_scheme: str, inter_scheme: str) -> CommPlan:
    return CommPlan((Stage(intra_scheme, 0), Stage(inter_scheme, 1)))


def _check_scheme(scheme: str, tag: str) -> None:
    """Reject plan tags naming unregistered or analytic-only schemes at
    parse time (the registry lists the valid names in the error), so a
    typo'd ``--sync`` or bucket tag fails before any tracing."""
    from repro_torch.core import registry as _registry  # deferred: no cycle at import

    spec = _registry.get_scheme(scheme)  # unknown -> ValueError w/ names
    if not spec.executable:
        raise ValueError(
            f"plan tag {tag!r}: scheme {scheme!r} is analytic-only (a "
            f"cost-model curve, not an executable collective); "
            f"executable schemes: "
            f"{', '.join(_registry.registered_schemes(executable_only=True))}")


def parse_plan(tag: str) -> CommPlan:
    """Inverse of ``CommPlan.tag()``.  Scheme tokens are validated
    against the scheme registry (``core/registry.py``)."""
    tag = tag.strip()
    if not tag.startswith("hier("):
        if "@" in tag or "(" in tag:
            raise ValueError(f"malformed plan tag {tag!r}")
        _check_scheme(tag, tag)
        return flat_plan(tag)
    if not tag.endswith(")"):
        raise ValueError(f"malformed plan tag {tag!r}")
    stages = []
    parts = tag[len("hier("):-1].split(",")
    if len(parts) != len(_ROLES):
        raise ValueError(
            f"malformed plan tag {tag!r}: hier() wants exactly "
            f"{len(_ROLES)} '@role' stages ({', '.join(_ROLES)})")
    for i, part in enumerate(parts):
        scheme, _, role = part.strip().partition("@")
        if not scheme or role != _ROLES[i]:
            raise ValueError(
                f"malformed plan tag {tag!r}: stage {i} must be "
                f"'<scheme>@{_ROLES[i]}', got {part.strip()!r}")
        _check_scheme(scheme, tag)
        stages.append(Stage(scheme, i))
    return CommPlan(tuple(stages))


def resolve_plan(tag: str, topology: Topology) -> CommPlan:
    """A bucket's executable plan from its tag and the topology.

    A bare scheme tag on a hierarchical topology means "that scheme at
    every level" (the explicit ``--sync zen`` user intent, applied
    per-level); ``hier(...)`` tags carry their own per-level schemes and
    must match the topology's level count."""
    plan = parse_plan(tag)
    if plan.flat and not topology.flat:
        s = plan.stages[0].scheme
        return hier_plan(s, s)
    if len(plan.stages) != len(topology.levels):
        raise ValueError(
            f"plan {tag!r} has {len(plan.stages)} stages but the topology "
            f"has {len(topology.levels)} levels ({topology.describe()})")
    return plan
