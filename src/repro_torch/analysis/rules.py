"""zenlint rule catalog: the paper's invariants over a traced sync.

The port's copy of ``repro.analysis.rules``.  Each rule takes a
:class:`Subject` (one sync, traced once by ``trace_ir``, with its
expectations) and returns :class:`Finding` s:

  R1  sort-free encode: no sort-family aten op (``sort``, whose
      decompositions ``argsort`` and ``msort`` reach, the ``unique``
      family, ``topk``, ``kthvalue``) among the sync's own ops.
  R2  wire-exact: the recorded collective bytes per group size equal the
      registry's ``wire_words_fn`` x 4 exactly, every kind is one the
      scheme registers, and the sync's ``SyncStats`` claim matches (== for
      saturable schemes, <= for over-provisioned ones like zen).
  R3  no silent promotion: no float64 output anywhere, and no reduction
      (``sum``, ``cumsum``, ``index_add``, ``scatter_add``, ``mean``, a
      kernel) whose result is narrower than its input.
  R4  overlap fences: in ``run_schedule`` encode(i+1) is issued before
      commit(i)'s first collective, no encode op reads a tensor derived
      from a collective (encode(i+1) independent of commit(i), the
      double-buffering contract) and, on the card, every encode runs on
      the side stream and every commit on the current one.
  R5  no dynamic fallbacks: no host sync (``.item()``, ``int(t)``:
      ``_local_scalar_dense``; ``torch.equal``), no device-to-host copy
      and no op whose output shape depends on the data (``nonzero``,
      ``masked_select``, ``bincount``, boolean indexing) among the sync's
      own ops; on the card, nothing the sync ran tripped
      ``torch.cuda.set_sync_debug_mode("error")``.

Rules are registered with :func:`rule`; a scheme can waive a rule via
``SchemeSpec.lint_exempt`` (``Subject.exempt``), which the driver prints
as an explicit waiver.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.analysis import trace_ir
from repro_torch.analysis.trace_ir import DTYPE_BYTES, FLOAT_DTYPES

REL_TOL = 1e-6

SORT_OPS = frozenset({"sort", "argsort", "msort", "topk", "kthvalue",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "unique_dim_consecutive"})
HOST_SYNC_OPS = frozenset({"_local_scalar_dense", "equal", "is_nonzero",
                           "item"})
DYNAMIC_SHAPE_OPS = frozenset({"nonzero", "nonzero_numpy", "argwhere",
                               "masked_select", "bincount",
                               "repeat_interleave", "_unique", "_unique2",
                               "unique_dim", "unique_consecutive",
                               "unique_dim_consecutive"})
REDUCTION_OPS = frozenset({"sum", "cumsum", "index_add", "scatter_add",
                           "mean"})


@dataclasses.dataclass
class Finding:
    rule: str
    message: str
    case: str = ""
    computation: str = ""
    op: str = ""

    def __str__(self) -> str:
        where = "/".join(x for x in (self.computation, self.op) if x)
        loc = f" [{where}]" if where else ""
        case = f" ({self.case})" if self.case else ""
        return f"{self.rule}{case}: {self.message}{loc}"


@dataclasses.dataclass
class WireExpectation:
    """R2 expectation for one group size (== one topology level)."""
    expected_bytes: float            # registry wire_words_fn x dtype bytes
    claimed_bytes: float             # SyncStats.sent_words x dtype bytes
    kinds: tuple[str, ...]           # allowed collective kinds
    claim_exact: bool = True         # saturable: claim == wire, else <=


@dataclasses.dataclass
class Subject:
    """One traced sync under verification."""
    label: str
    records: list | None = None            # trace_ir records, issue order
    wire: dict[int, WireExpectation] | None = None
    expected_fences: int = 0               # run_schedule hand-offs: nb - 1
    fences_collective_free: bool = False   # flat pipeline: see R4
    streams: tuple[int, int] | None = None  # (side, current), on the card
    host_syncs: tuple[str, ...] = ()       # set_sync_debug_mode errors
    exempt: tuple[str, ...] = ()


RuleFn = Callable[[Subject], list[Finding]]
RULES: dict[str, tuple[str, RuleFn]] = {}


def rule(rid: str, title: str):
    def deco(fn: RuleFn) -> RuleFn:
        RULES[rid] = (title, fn)
        return fn
    return deco


def run_rules(subject: Subject) -> list[Finding]:
    findings: list[Finding] = []
    for rid in sorted(RULES):
        if rid in subject.exempt:
            continue
        _title, fn = RULES[rid]
        for f in fn(subject):
            f.case = f.case or subject.label
            findings.append(f)
    return findings


def _ops(s: Subject) -> list[trace_ir.OpRecord]:
    return [r for r in s.records or () if isinstance(r, trace_ir.OpRecord)]


def _where(r) -> str:
    return f"{r.phase[0]}({r.phase[1]})" if r.phase else ""


# ---------------------------------------------------------------- R1

@rule("R1", "sort-free encode")
def _r1_no_sorts(s: Subject) -> list[Finding]:
    return [Finding("R1", f"sort-family op {r.name} in the sync",
                    computation=_where(r), op=r.op)
            for r in _ops(s) if r.name in SORT_OPS]


# ---------------------------------------------------------------- R2

# The reference pools its collective-permute levels because a permute's
# HLO pairs cannot recover the communicator size.  The recorded ppermute
# knows its group, but the same pooling keeps the two catalogs one: the
# permute-only levels are held to a pooled byte total, and each level's
# SyncStats claim to the registry formula.
POOLED_KINDS = frozenset({"collective-permute"})


def _claim_findings(exp: WireExpectation, got: float, where: str
                    ) -> list[Finding]:
    if exp.claim_exact:
        if abs(exp.claimed_bytes - got) > REL_TOL * max(1.0, got):
            return [Finding(
                "R2", f"{where}: SyncStats claim {exp.claimed_bytes:.0f} B "
                      f"!= wire {got:.0f} B (scheme is marked saturable)")]
    elif exp.claimed_bytes > got * (1 + REL_TOL) + REL_TOL:
        return [Finding(
            "R2", f"{where}: SyncStats claim {exp.claimed_bytes:.0f} B "
                  f"exceeds wire {got:.0f} B")]
    return []


@rule("R2", "wire-exact collective bytes")
def _r2_wire_exact(s: Subject) -> list[Finding]:
    if s.records is None or s.wire is None:
        return []
    out = []
    pooled = {g: e for g, e in s.wire.items()
              if e.kinds and set(e.kinds) <= POOLED_KINDS}
    grouped = {g: e for g, e in s.wire.items() if g not in pooled}
    measured = trace_ir.collective_wire(s.records)
    by_group: dict[int, float] = {}
    pooled_got = 0.0
    for (base, g), b in sorted(measured.items()):
        if base in POOLED_KINDS and pooled:
            pooled_got += b
            continue
        by_group[g] = by_group.get(g, 0.0) + b
        exp = grouped.get(g)
        if exp is None:
            out.append(Finding(
                "R2", f"collective {base} at unexpected group size {g} "
                      f"({b:.0f} wire bytes; levels expect "
                      f"{sorted(s.wire)})"))
        elif base not in exp.kinds:
            out.append(Finding(
                "R2", f"unexpected collective kind {base} at group size "
                      f"{g} (registry expects {exp.kinds})"))
    for g, exp in sorted(grouped.items()):
        got = by_group.get(g, 0.0)
        if abs(got - exp.expected_bytes) > REL_TOL * max(
                1.0, exp.expected_bytes):
            out.append(Finding(
                "R2", f"group size {g}: measured wire {got:.0f} B != "
                      f"expected {exp.expected_bytes:.0f} B"))
            continue
        out.extend(_claim_findings(exp, got, f"group size {g}"))
    if pooled:
        want = sum(e.expected_bytes for e in pooled.values())
        if abs(pooled_got - want) > REL_TOL * max(1.0, want):
            out.append(Finding(
                "R2", f"pooled collective-permute wire {pooled_got:.0f} B "
                      f"!= expected {want:.0f} B (levels {sorted(pooled)})"))
        for g, exp in sorted(pooled.items()):
            out.extend(_claim_findings(exp, exp.expected_bytes,
                                       f"group size {g} (pooled)"))
    return out


# ---------------------------------------------------------------- R3

def _narrowed(r: trace_ir.OpRecord) -> str | None:
    """The narrower result dtype of a reduction or kernel, if any."""
    if r.op.startswith("kernel:"):
        fin = [d for d in r.in_dtypes if d in FLOAT_DTYPES]
        fout = [d for d in r.out_dtypes if d in FLOAT_DTYPES]
        if fin and fout and min(DTYPE_BYTES[d] for d in fout) < max(
                DTYPE_BYTES[d] for d in fin):
            return f"{min(fout, key=DTYPE_BYTES.get)} < {max(fin, key=DTYPE_BYTES.get)}"
        return None
    if r.name in REDUCTION_OPS and r.in_dtypes and r.out_dtypes:
        src, res = r.in_dtypes[0], r.out_dtypes[0]
        if DTYPE_BYTES.get(res, 8) < DTYPE_BYTES.get(src, 0):
            return f"{res} < {src}"
    return None


@rule("R3", "no silent promotion")
def _r3_no_promotion(s: Subject) -> list[Finding]:
    out = []
    for r in _ops(s):
        if "f64" in r.out_dtypes:
            what = ("f64 cast" if r.name in ("_to_copy", "copy")
                    else f"f64 result of {r.name}")
            out.append(Finding("R3", f"double precision leak: {what}",
                               computation=_where(r), op=r.op))
            continue
        narrow = _narrowed(r)
        if narrow:
            out.append(Finding(
                "R3", f"reduction accumulator narrower than its input "
                      f"({narrow})", computation=_where(r), op=r.op))
    return out


# ---------------------------------------------------------------- R4

def fence_dependence_findings(records, case: str = "") -> list[Finding]:
    """Flag encode ops that read a tensor derived from a collective.

    In the flat ``run_schedule`` pipeline every encode is collective-free
    and reads its own bucket's payload; an encode input tainted by a
    collective means encode(i+1) depends on commit(i): the overlap is
    dead."""
    return [Finding("R4", "encode op reads a collective's output: "
                          "encode(i+1) is not independent of commit(i)",
                    case=case, computation=_where(r), op=r.op)
            for r in records if isinstance(r, trace_ir.OpRecord)
            and r.phase and r.phase[0] == "encode" and r.tainted]


def _first(records, pred) -> int | None:
    return next((i for i, r in enumerate(records) if pred(r)), None)


@rule("R4", "overlap fences present")
def _r4_fences(s: Subject) -> list[Finding]:
    out = []
    recs = s.records or []
    for i in range(s.expected_fences):
        enc = _first(recs, lambda r: r.phase == ("encode", i + 1))
        coll = _first(recs, lambda r: isinstance(
            r, trace_ir.CollectiveRecord) and r.phase == ("commit", i))
        if enc is None or (coll is not None and enc > coll):
            out.append(Finding(
                "R4", f"encode({i + 1}) not issued before commit({i})'s "
                      f"first collective: the run_schedule hand-off was "
                      f"dropped"))
    if s.fences_collective_free:
        out.extend(fence_dependence_findings(recs, case=s.label))
    if s.streams is not None:
        side, main = s.streams
        for r in recs:
            if not r.phase or r.stream is None:
                continue
            want = side if r.phase[0] == "encode" else main
            if r.stream != want:
                out.append(Finding(
                    "R4", f"{r.phase[0]} ran on stream {r.stream:#x}, not "
                          f"the {'side' if want == side else 'current'} "
                          f"stream {want:#x}", computation=_where(r),
                    op=getattr(r, "op", r.__class__.__name__)))
    return out


# ---------------------------------------------------------------- R5

@rule("R5", "no dynamic fallbacks")
def _r5_static(s: Subject) -> list[Finding]:
    out = [Finding("R5", f"host sync under set_sync_debug_mode: {e}")
           for e in s.host_syncs]
    for r in _ops(s):
        if r.name in HOST_SYNC_OPS:
            msg = f"host sync ({r.name}: .item() / int(t))"
        elif r.device_to_host:
            msg = "device-to-host copy"
        elif r.name in DYNAMIC_SHAPE_OPS:
            msg = f"data-dependent output shape ({r.name})"
        elif r.bool_index:
            msg = f"boolean-mask indexing ({r.name})"
        else:
            continue
        out.append(Finding("R5", msg, computation=_where(r), op=r.op))
    return out
