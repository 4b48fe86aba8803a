"""Scheme registry: the single surface a communication scheme plugs into
(a copy of ``repro.core.registry`` for the port).

A :class:`SchemeSpec` registered once via :func:`register_scheme` feeds:

* ``schemes.stage_sync``, which dispatches through :func:`get_scheme` (the
  executable ``sync_fn``, with per-scheme :class:`StageArgs` validation);
* ``costmodel.SCHEMES`` / ``costmodel.ROUNDS``, live views over the
  registered ``volume_fn`` / ``rounds_fn``;
* ``costmodel.candidate_plans``, which filters on ``plan_candidate`` and
  per-level feasibility;
* ``topology.parse_plan``, which rejects unregistered scheme names;
* ``launch/train.py``, whose ``--sync`` choices are
  :func:`cli_scheme_choices`.

This module is pure Python.  The registrations live at the bottom of
``core/costmodel.py`` (which owns the volume and round formulas);
executable sync functions are named, and resolved lazily from
``repro_torch.core.schemes`` at dispatch time.

The spec also carries the metadata of the port's zenlint
(``repro_torch.analysis``), with the reference's values: ``wire_words_fn``
(each scheme's exact wire-word contract), ``expected_collectives`` (the
collective kinds its sync may run, under the reference's names),
``lint_saturable``, ``lint_density``, ``lint_caps_fn``, ``lint_exempt``
and ``lint_routes`` (compute-route variants the sweep also certifies).
The lint reads them on a trace of the sync's torch ops and of the
collectives its group ran, not on a lowered program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

# Histogram resolution of the balanced scheme's boundary rebalance: the
# index space is split into min(M, BALANCED_BINS) equal-width bins whose
# global multiset counts (one f32 allreduce) place the range boundaries.
# Shared between the executable scheme (core/schemes.py) and its volume
# formula (core/costmodel.py).
BALANCED_BINS = 256


@dataclasses.dataclass(frozen=True)
class StageArgs:
    """Typed per-stage arguments for one ``stage_sync`` call.

    One dataclass covers every scheme; a :class:`SchemeSpec` declares
    which fields it consumes (``stage_args``) and which are mandatory
    (``required_args``).  Setting a field a scheme does not consume is a
    config error surfaced at plan-build time (:func:`validate_stage_args`).
    """

    capacity: int | None = None       # per-worker nnz budget (COO schemes)
    cap_push: int | None = None       # per-destination push slots (PS family)
    cap_pull: int | None = None       # aggregated-shard pull slots (PS family)
    block: int | None = None          # omnireduce block size
    bins: int | None = None           # balanced histogram bins (default: BALANCED_BINS)
    layout: Any = None                # ZenLayout (zen only)
    use_hash_bitmap: bool = True      # zen pull format (Fig. 18 ablation)
    backend: str = "torch"            # kernel route: "torch" | "cuda"
    interpret: bool | None = None     # kept for the reference's field set; unused
    fused: bool | None = None         # zen fused-encode kernel toggle
    fused_commit: bool | None = None  # zen fused-commit kernel toggle

    def set_fields(self) -> tuple[str, ...]:
        """Names of fields set to a non-default value."""
        return tuple(
            f.name for f in dataclasses.fields(self)
            if getattr(self, f.name) != f.default
        )


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """Everything the port needs to know about one communication scheme.

    ``sync_fn`` is the attribute name of the executable function on
    ``repro_torch.core.schemes`` (resolved lazily), or ``None`` for
    analytic-only entries (``balanced_parallelism``, ``lower_bound``) that
    exist purely as cost-model curves.
    """

    name: str
    sync_fn: str | None                       # attr name on core.schemes
    volume_fn: Callable                       # (SparsityProfile, n) -> words
    rounds_fn: Callable[[int], float]         # n -> message rounds (α term)
    stage_args: tuple[str, ...] = ()          # StageArgs fields consumed
    required_args: tuple = ()                 # names, or tuples = any-of groups
    arg_aliases: tuple = ()                   # ((src, (dst, ...)), ...): src fills unset dsts
    arg_defaults: tuple = ()                  # ((field, value), ...) when unset
    needs_n: bool = False                     # sync_fn takes a static n kwarg
    plan_candidate: bool = False              # choose_plan may pick it
    feasible_fn: Callable[[int, int], bool] | None = None  # (n, M) -> bool

    # -- zenlint metadata (repro_torch.analysis) ---------------------------
    # wire_words_fn(M, n, kw) -> exact per-worker wire words at the given
    # stage kwargs (value width 1); kw is the stage_kwargs() output.  None
    # on an executable scheme is itself a lint finding.
    wire_words_fn: Callable | None = None
    # collective kinds the sync may run ("all-reduce", "all-gather",
    # "all-to-all", "collective-permute"): psum, all_gather, all_to_all and
    # ppermute of the group
    expected_collectives: tuple[str, ...] = ()
    # saturable: a fully-dense payload at lint_caps_fn caps makes the
    # SyncStats claim equal the wire exactly (R2 ==); zen's hash buffers
    # are r1_factor over-provisioned by design, so it is not (claim <=)
    lint_saturable: bool = False
    lint_density: float = 1.0                 # payload density for the sweep
    # lint_caps_fn(M, n) -> StageArgs kwargs that exactly saturate the
    # scheme at that payload (schemes taking a layout build it in-driver)
    lint_caps_fn: Callable | None = None
    lint_exempt: tuple[str, ...] = ()         # waived rule ids, e.g. ("R5",)
    # extra compute-route variants the lint sweep must also certify:
    # ((label, ((StageArgs field, value), ...)), ...), each a flat sweep
    # with those fields overridden and the same wire contract
    lint_routes: tuple = ()

    @property
    def executable(self) -> bool:
        return self.sync_fn is not None

    def resolve_sync(self) -> Callable:
        if self.sync_fn is None:
            raise ValueError(
                f"scheme {self.name!r} is analytic-only (a cost-model "
                f"curve, not an executable collective); executable "
                f"schemes: {', '.join(registered_schemes(executable_only=True))}")
        from repro_torch.core import schemes  # deferred: schemes import us

        return getattr(schemes, self.sync_fn)

    def feasible(self, n: int, M: int = 0) -> bool:
        """Whether this scheme can run at a level of size ``n`` (static
        shape / divisibility constraints)."""
        if n <= 1:
            return self.name == "dense"  # size-1 level: only the free identity
        if self.feasible_fn is None:
            return True
        return self.feasible_fn(n, M)


_REGISTRY: dict[str, SchemeSpec] = {}


def register_scheme(
    name: str,
    sync_fn: str | None,
    volume_fn: Callable,
    rounds_fn: Callable[[int], float],
    stage_args: tuple[str, ...] = (),
    *,
    required_args: tuple = (),
    arg_aliases: tuple = (),
    arg_defaults: tuple = (),
    needs_n: bool = False,
    plan_candidate: bool = False,
    feasible_fn: Callable[[int, int], bool] | None = None,
    wire_words_fn: Callable | None = None,
    expected_collectives: tuple[str, ...] = (),
    lint_saturable: bool = False,
    lint_density: float = 1.0,
    lint_caps_fn: Callable | None = None,
    lint_exempt: tuple[str, ...] = (),
    lint_routes: tuple = (),
) -> SchemeSpec:
    """Register one scheme.  Re-registering a name replaces it (tests)."""
    valid = {f.name for f in dataclasses.fields(StageArgs)}
    unknown = [a for a in stage_args if a not in valid]
    if unknown:
        raise ValueError(
            f"register_scheme({name!r}): stage_args {unknown} are not "
            f"StageArgs fields ({', '.join(sorted(valid))})")
    spec = SchemeSpec(
        name=name, sync_fn=sync_fn, volume_fn=volume_fn,
        rounds_fn=rounds_fn, stage_args=tuple(stage_args),
        required_args=tuple(required_args), arg_aliases=tuple(arg_aliases),
        arg_defaults=tuple(arg_defaults), needs_n=needs_n,
        plan_candidate=plan_candidate, feasible_fn=feasible_fn,
        wire_words_fn=wire_words_fn,
        expected_collectives=tuple(expected_collectives),
        lint_saturable=lint_saturable, lint_density=lint_density,
        lint_caps_fn=lint_caps_fn, lint_exempt=tuple(lint_exempt),
        lint_routes=tuple(lint_routes))
    _REGISTRY[name] = spec
    return spec


def _ensure_registered() -> None:
    """Populate the registry on first use (the registrations live at the
    bottom of ``core/costmodel.py``)."""
    if not _REGISTRY:
        from repro_torch.core import costmodel  # noqa: F401  (registration side effect)


def get_scheme(name: str) -> SchemeSpec:
    _ensure_registered()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown scheme {name!r}: registered schemes are "
            f"{', '.join(registered_schemes())} "
            f"(add new ones via repro_torch.core.registry.register_scheme)")
    return spec


def registered_schemes(*, executable_only: bool = False) -> tuple[str, ...]:
    _ensure_registered()
    return tuple(n for n, s in _REGISTRY.items()
                 if s.executable or not executable_only)


def plan_candidates() -> tuple[str, ...]:
    """Schemes ``choose_plan`` may pick, in registration order (dense
    first: argmin ties must resolve toward dense)."""
    _ensure_registered()
    return tuple(n for n, s in _REGISTRY.items() if s.plan_candidate)


def cli_scheme_choices() -> list[str]:
    """``--sync`` choices of ``launch/train.py``: every executable scheme
    plus the per-tensor 'auto' decision."""
    return [*registered_schemes(executable_only=True), "auto"]


def validate_stage_args(spec: SchemeSpec, args: StageArgs, where: str = "") -> None:
    """Config-named errors for one stage's arguments, raised at plan-build
    time, before any collective runs."""
    ctx = f" ({where})" if where else ""
    accepted = set(spec.stage_args)
    stray = [f for f in args.set_fields() if f not in accepted]
    if stray:
        raise ValueError(
            f"scheme {spec.name!r} does not consume stage arg(s) "
            f"{', '.join(stray)}{ctx}; it accepts: "
            f"{', '.join(spec.stage_args) or '(none)'}")
    for req in spec.required_args:
        alts = req if isinstance(req, tuple) else (req,)
        if all(getattr(args, a) is None for a in alts):
            raise ValueError(
                f"scheme {spec.name!r} requires stage arg "
                f"{' or '.join(alts)}{ctx} — size it from the density "
                f"budget (see schemes.plan_stage_args / SyncConfig."
                f"density_budget)")


def stage_kwargs(spec: SchemeSpec, args: StageArgs) -> dict:
    """The keyword arguments ``spec``'s sync function actually receives:
    consumed fields only, aliases applied (e.g. ``capacity`` filling
    ``cap_push``/``cap_pull``), per-scheme defaults filled, unset (None)
    fields dropped so the function's own defaults apply."""
    vals = {f: getattr(args, f) for f in spec.stage_args}
    for src, dsts in spec.arg_aliases:
        for d in dsts:
            if vals.get(d) is None and vals.get(src) is not None:
                vals[d] = vals[src]
        vals.pop(src, None)
    for field, default in spec.arg_defaults:
        if vals.get(field) is None:
            vals[field] = default
    return {k: v for k, v in vals.items() if v is not None}


def coverage_errors(tests_dir: str = "tests") -> list[str]:
    """Every registered scheme must carry a volume and a rounds function
    that evaluate sanely, and every *executable* scheme must appear in a
    test file of the port (``test_torch_*.py``).  Returns the violations
    (empty = covered)."""
    import glob
    import os

    _ensure_registered()
    from repro_torch.core import costmodel as cm

    # probe profile with every curve populated (block curves included:
    # omnireduce's volume asserts on them)
    p = cm.SparsityProfile(
        M=1 << 12, d=lambda i: min(1.0, 0.1 * max(i, 1)),
        s=lambda n: 1.0,
        block_density=lambda i: min(1.0, 0.2 * max(i, 1)),
        block_max=lambda i, parts: min(1.0, 0.2 * max(i, 1)))
    corpus = ""
    for path in sorted(glob.glob(os.path.join(tests_dir, "test_torch_*.py"))):
        with open(path) as f:
            corpus += f.read()
    errors = []
    for name in registered_schemes():
        spec = get_scheme(name)
        try:
            r = float(spec.rounds_fn(8))
            v = float(spec.volume_fn(p, 8))
        except Exception as e:  # pragma: no cover - defensive
            errors.append(f"{name}: volume/rounds evaluation failed: {e}")
            continue
        if not (r > 0):
            errors.append(f"{name}: rounds_fn(8) = {r} (must be > 0)")
        if not (v >= 0):
            errors.append(f"{name}: volume_fn(p, 8) = {v} (must be >= 0)")
        if spec.executable and f'"{name}"' not in corpus \
                and f"'{name}'" not in corpus \
                and (spec.sync_fn or "") not in corpus:
            errors.append(
                f"{name}: executable scheme has no parity test "
                f"(no test_torch_*.py under {tests_dir}/ mentions it)")
    return errors
