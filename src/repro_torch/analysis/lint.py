"""zenlint driver: certify every registered scheme's sync on a trace.

``python -m repro_torch.analysis.lint`` runs three layers and exits
non-zero on any finding (the port's ``repro.analysis.lint``):

  * AST lint (``--ast-only``): the registry-contract rules AST1-AST3 over
    the source tree (``ast_rules``).
  * Registry coverage (``--registry-only``): every scheme has sane volume
    and round functions and a parity test (``registry.coverage_errors``).
  * Trace sweep (``--trace-only``, the counterpart of the reference's
    ``--hlo-only``): for every executable scheme x {flat, hier} x n in
    {2, 8}, each of a scheme's ``lint_routes`` and the ``run_schedule``
    pipeline, run a saturating sync once under ``trace_ir``'s recording
    group and op trace, and hold the trace to the R1-R5 catalog
    (``rules``).  The wire expectations come from the registry's
    ``wire_words_fn`` at ``lint_caps_fn`` (Zen: a layout at twice its
    ``lint_density``, with the reference sweep's hash seeds, so every
    expectation is the reference's to the byte); a scheme registered
    without lint metadata is itself a finding.

Every stage runs on the kernel route (``backend="cuda"``): the CUDA
kernels on the card (``--device cuda``, the default; nothing falls back
to the CPU), their plain versions on the CPU (``--device cpu``).  On the
card each traced sync also runs under
``torch.cuda.set_sync_debug_mode("error")``.  ``--group sim`` (default)
runs the n workers in this process (``SimGroup``); ``--group dist`` runs
this process's rank of a ``torchrun`` world over gloo (``DistGroup``; n
is the world size).

The sweep checks each result too: an overflow, or a result that is not
the sum of the workers (the payload's values are dyadic, so the sums are
exact), is a DRIVER finding: a lint that certified the bytes of a wrong
sync would be theater.

    PYTHONPATH=src python -m repro_torch.analysis.lint --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.analysis import ast_rules, rules, trace_ir
from repro_torch.analysis.rules import Finding, Subject, WireExpectation

WORD = 4  # f32/i32 wire word, bytes

DEFAULT_NS = (2, 8)
DEFAULT_M = 4096
SCHED_BUCKETS = 3
# The hash seeds of the reference sweep's Zen layouts (its default key 0):
# the same seeds give the same partitions, so the same cap_server and
# bitmap words, so the same expected bytes.
LINT_SEEDS = (31327078, 89727313, 349724619, 1554082366)


def _payload(M: int, n: int, density: float) -> np.ndarray:
    """Per-worker [n, M] grads: identical support on every worker (claims
    stay worker-symmetric), distinct dyadic values (sums are exact)."""
    g = np.zeros((n, M), np.float32)
    stride = max(1, int(round(1.0 / density)))
    pos = np.arange(0, M, stride)
    for i in range(n):
        g[i, pos] = 1.0 + i / 8.0 + (pos % 7) / 64.0
    return g


def _stage_setup(spec, M: int, n_level: int, device, overrides=None):
    """(StageArgs, expected wire words) for one level of size n_level, on
    the kernel route.

    ``overrides``: ((StageArgs field, value), ...) of a
    ``SchemeSpec.lint_routes`` entry, a compute route that must meet the
    SAME wire contract: the expectation is computed from the kwargs
    without them, so a route that changed a transmitted word fails R2."""
    from repro_torch.core import registry as sreg
    from repro_torch.core import schemes

    kwargs = dict(spec.lint_caps_fn(M, n_level)) if spec.lint_caps_fn else {}
    if "backend" in spec.stage_args:
        kwargs["backend"] = "cuda"
    args = sreg.StageArgs(**kwargs)
    if "layout" in spec.stage_args:
        layout = schemes.make_zen_layout(
            M, n_level, density_budget=min(1.0, 2 * spec.lint_density),
            seeds=LINT_SEEDS)
        layout.tables(device)   # offline state: uploaded before the sync
        args = dataclasses.replace(args, layout=layout)
    kw = sreg.stage_kwargs(spec, args)
    exp_words = (spec.wire_words_fn(M, n_level, kw)
                 if spec.wire_words_fn else None)
    if overrides:
        args = dataclasses.replace(args, **dict(overrides))
    return args, exp_words


def _meta_findings(spec, label: str) -> list[Finding]:
    """A scheme cannot enter the sweep without its wire contract."""
    missing = [f for f, v in (("wire_words_fn", spec.wire_words_fn),
                              ("expected_collectives",
                               spec.expected_collectives)) if not v]
    if not missing:
        return []
    return [Finding(
        "R2", f"scheme {spec.name!r} registered without zenlint metadata "
              f"({', '.join(missing)}): register the wire contract "
              f"(core/costmodel.py) before it can be certified",
        case=label)]


@contextlib.contextmanager
def _sync_debug(device: torch.device):
    """``set_sync_debug_mode("error")`` on the card, for the traced sync."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _where(e: BaseException) -> str:
    """``file:line`` of the innermost frame of the port's own code (not
    the lint's) in ``e``'s traceback."""
    import traceback

    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename
              and "/analysis/" not in f.filename.replace("\\", "/")]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename.split('src/', 1)[-1]}:{f.lineno}"


def trace_sync(fn, group, device):
    """Run ``fn(recording group)`` once under an ``OpTrace``: (its result
    or None, the trace's records, the host syncs the card refused)."""
    tr = trace_ir.OpTrace()
    rec = trace_ir.RecordingGroup(group, tr)
    host: list[str] = []
    res = None
    with _sync_debug(device):
        try:
            with tr:
                res = fn(rec, tr)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            host.append(f"{str(e).splitlines()[0]} at {_where(e)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, tr.records, tuple(host)


class _World:
    """Where a subject runs: ``n`` workers in this process (``group`` None:
    a ``SimGroup``) or this rank of ``group`` (a ``DistGroup``)."""

    def __init__(self, device, group=None):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the payload's own device, as the sync's tables key it
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.group = group

    def make(self, n: int):
        from repro_torch.core.schemes import SimGroup
        if self.group is None:
            return SimGroup(n)
        if self.group.n != n:
            raise ValueError(f"--group dist: n={n} but the world has "
                             f"{self.group.n} ranks")
        return self.group

    def rows(self, g: np.ndarray) -> torch.Tensor:
        """This process's workers' rows of the [n, ...] payload."""
        if self.group is not None:
            r = self.group.ranks[0]
            g = g[r:r + 1]
        return torch.as_tensor(np.ascontiguousarray(g), device=self.device)


def _driver_findings(res, want: np.ndarray, label: str, atol: float = 1e-5
                     ) -> list[Finding]:
    out, ov = res
    findings = []
    ovf = int(ov.sum())
    if ovf:
        findings.append(Finding(
            "DRIVER", f"lint payload overflowed a capacity (overflow={ovf}):"
                      f" lint_caps_fn does not saturate exactly", case=label))
    got = out.float().cpu().numpy()
    if not np.allclose(got, np.broadcast_to(want, got.shape), atol=atol):
        err = float(np.abs(got - want).max())
        findings.append(Finding(
            "DRIVER", f"synced result != sum of workers (max err "
                      f"{err:.2e})", case=label))
    return findings


def build_flat_subject(scheme: str, n: int, M: int, route=None,
                       world: _World | None = None
                       ) -> tuple[Subject | None, list[Finding]]:
    from repro_torch.core import registry as sreg
    from repro_torch.core import schemes

    world = world or _World("cpu")
    label = f"{scheme} flat n={n}"
    overrides = None
    if route is not None:
        rlabel, overrides = route
        label = f"{label} [{rlabel}]"
    spec = sreg.get_scheme(scheme)
    findings = _meta_findings(spec, label)
    if findings:
        return None, findings
    args, exp_words = _stage_setup(spec, M, n, world.device, overrides)
    g = _payload(M, n, spec.lint_density)
    x = world.rows(g)

    def sync(rec, _tr):
        return schemes.stage_sync(scheme, x, group=rec, n=n,
                                  stage_args=args)

    res, records, host = trace_sync(sync, world.make(n), world.device)
    claimed = 0.0
    if res is not None:
        out, st = res
        findings += _driver_findings((out, st.overflow), g.sum(0), label)
        claimed = float(st.sent_words.max()) * WORD
    subject = Subject(
        label=label, records=records,
        wire={n: WireExpectation(
            expected_bytes=exp_words * WORD, claimed_bytes=claimed,
            kinds=spec.expected_collectives,
            claim_exact=spec.lint_saturable)},
        host_syncs=host, exempt=spec.lint_exempt)
    return subject, findings


def build_hier_subject(scheme: str, n: int, M: int, node_size: int = 2,
                       world: _World | None = None
                       ) -> tuple[Subject | None, list[Finding]]:
    from repro_torch.core import registry as sreg
    from repro_torch.core import schemes
    from repro_torch.core import topology as tp

    world = world or _World("cpu")
    label = f"hier({scheme}@intra,{scheme}@inter) n={n} node={node_size}"
    spec = sreg.get_scheme(scheme)
    findings = _meta_findings(spec, label)
    if findings:
        return None, findings
    topo = tp.build_topology(n, node_size)
    plan = tp.hier_plan(scheme, scheme)
    stage_kw, wire = {}, {}
    for li, lvl in enumerate(topo.levels):
        if lvl.size <= 1:
            continue
        if not spec.feasible(lvl.size, M):
            return None, []  # this scheme cannot run at this level size
        args, exp_words = _stage_setup(spec, M, lvl.size, world.device)
        stage_kw[li] = args
        # keyed by group size, as R2 measures: two levels of one size (n 4
        # in nodes of 2) add up
        wire[lvl.size] = wire.get(lvl.size, 0.0) + exp_words
    g = _payload(M, n, spec.lint_density)
    x = world.rows(g)

    def sync(rec, _tr):
        return schemes.hier_sync(x, group=rec, topology=topo, plan=plan,
                                 stage_kw=stage_kw)

    res, records, host = trace_sync(sync, world.make(n), world.device)
    claimed: dict[int, float] = {}
    if res is not None:
        out, st = res
        findings += _driver_findings((out, st.overflow), g.sum(0), label)
        for stage, words in zip(plan.stages, st.by_level):
            size = topo.levels[stage.level].size
            claimed[size] = claimed.get(size, 0.0) + float(words.max()) * WORD
    expectations = {size: WireExpectation(
        expected_bytes=words * WORD, claimed_bytes=claimed.get(size, 0.0),
        kinds=spec.expected_collectives, claim_exact=spec.lint_saturable)
        for size, words in wire.items()}
    subject = Subject(label=label, records=records, wire=expectations,
                      host_syncs=host, exempt=spec.lint_exempt)
    return subject, findings


def build_schedule_subject(n: int = 8, M: int = 2048, nb: int = SCHED_BUCKETS,
                           world: _World | None = None
                           ) -> tuple[Subject, list[Finding]]:
    """The ``run_schedule`` overlap pipeline as a lint subject (R4).

    A flat Zen pipeline over ``nb`` buckets on the kernel route: every
    encode is collective-free, so no encode op may read a tensor derived
    from a collective, and encode(i+1) is issued before commit(i)'s first
    collective (on the card: on the side stream, the commits on the
    current one), the double-buffering contract (``train/schedule.py``)."""
    from repro_torch.core import buckets as bk
    from repro_torch.core import schemes
    from repro_torch.train import schedule

    world = world or _World("cpu")
    dev = world.device
    label = f"run_schedule zen nb={nb} flat n={n}"
    density = 0.25
    layout = schemes.make_zen_layout(M, n, density_budget=2 * density,
                                     seeds=LINT_SEEDS)
    layout.tables(dev)
    bucks = [bk.Bucket(bid=i, kind=bk.DENSE, scheme="zen",
                       slots=(bk.LeafSlot(f"w{i}", i, (M,), torch.float32,
                                          0, M),),
                       nbytes=M * WORD)
             for i in range(nb)]
    base = _payload(M, n, density)
    g = np.stack([base * (1 + b / 16.0) for b in range(nb)])  # [nb, n, M]
    payloads = [world.rows(g[b]) for b in range(nb)]
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    streams = None if stream is None else (
        stream.cuda_stream, torch.cuda.current_stream(dev).cuda_stream)

    def sync(rec, tr):
        def encode(b, p):
            with tr.phase("encode", b.bid):
                return p, schemes.zen_encode(p, layout=layout,
                                             backend="cuda")

        def commit(b, pe):
            p, enc = pe
            with tr.phase("commit", b.bid):
                return schemes.zen_commit(enc, p, group=rec, layout=layout,
                                          backend="cuda")

        return schedule.run_schedule(bucks, payloads, encode, commit,
                                     stream=stream)

    res, records, host = trace_sync(sync, world.make(n), dev)
    findings: list[Finding] = []
    if res is not None:
        outs, stats = res
        for b in range(nb):
            findings += _driver_findings(
                (outs[b], stats[b].overflow), g[b].sum(0),
                f"{label} bucket {b}", atol=1e-4)
    subject = Subject(label=label, records=records,
                      expected_fences=nb - 1, fences_collective_free=True,
                      streams=streams, host_syncs=host)
    return subject, findings


def run_trace_sweep(schemes_filter: list[str] | None = None,
                    ns: tuple[int, ...] = DEFAULT_NS, M: int = DEFAULT_M,
                    with_schedule: bool = True, verbose: bool = True,
                    device="cpu", group=None
                    ) -> tuple[list[Finding], dict[str, dict]]:
    """The R1-R5 sweep: (findings, ``{case label: collective_wire}``).
    ``group``: a ``DistGroup`` to run this rank of (n must be its size),
    or None for the in-process ``SimGroup``."""
    from repro_torch.core import registry as sreg

    world = _World(device, group)
    findings: list[Finding] = []
    wires: dict[str, dict] = {}
    names = sreg.registered_schemes(executable_only=True)
    if schemes_filter:
        unknown = sorted(set(schemes_filter) - set(names))
        if unknown:
            raise SystemExit(f"unknown scheme(s): {', '.join(unknown)} "
                             f"(executable: {', '.join(names)})")
        names = tuple(s for s in names if s in schemes_filter)

    def check(subject, extra):
        findings.extend(extra)
        if subject is None:
            return
        got = rules.run_rules(subject)
        findings.extend(got)
        wires[subject.label] = trace_ir.collective_wire(subject.records)
        if verbose:
            n = len(got) + len(extra)
            print(f"  {subject.label}: "
                  f"{'ok' if not n else f'{n} finding(s)'}", flush=True)

    for scheme in names:
        spec = sreg.get_scheme(scheme)
        for waived in spec.lint_exempt:
            print(f"  WAIVED {scheme}: rule {waived} "
                  f"(SchemeSpec.lint_exempt)")
        for n in ns:
            if spec.feasible(n, M):
                check(*build_flat_subject(scheme, n, M, world=world))
            check(*build_hier_subject(scheme, n, M, world=world))
            # compute-route variants (SchemeSpec.lint_routes): the same
            # R1-R5 catalog and the same wire contract
            for route in spec.lint_routes:
                if spec.feasible(n, M):
                    check(*build_flat_subject(scheme, n, M, route=route,
                                              world=world))
    want_sched = (not schemes_filter
                  or "zen" in schemes_filter)  # zenlint: ignore[AST2] the schedule subject is Zen's pipeline
    if with_schedule and want_sched:
        check(*build_schedule_subject(n=ns[-1], world=world))
    return findings, wires


def registry_findings(tests_dir: str = "tests") -> list[Finding]:
    from repro_torch.core import registry as sreg
    return [Finding("REG", e, case="registry coverage")
            for e in sreg.coverage_errors(tests_dir)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="zenlint: certify every registered scheme's traced "
                    "sync against the R1-R5 invariant catalog, the "
                    "registry contract (AST), and registry coverage.")
    layer = ap.add_mutually_exclusive_group()
    layer.add_argument("--ast-only", action="store_true",
                       help="source-tree registry-contract lint only")
    layer.add_argument("--trace-only", action="store_true",
                       help="trace sweep (R1-R5) only")
    layer.add_argument("--registry-only", action="store_true",
                       help="registry-coverage check only")
    ap.add_argument("--schemes", default=None,
                    help="comma-separated scheme filter for the sweep")
    ap.add_argument("--ns", default=None,
                    help="comma-separated worker counts (default 2,8; "
                         "--group dist: the world size)")
    ap.add_argument("--m", type=int, default=DEFAULT_M,
                    help=f"payload length (default {DEFAULT_M})")
    ap.add_argument("--tree", default="src/repro_torch",
                    help="root for the AST layer")
    ap.add_argument("--tests-dir", default="tests",
                    help="test dir for registry coverage")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--group", default="sim", choices=("sim", "dist"),
                    help="sim: n workers in this process; dist: this rank "
                         "of a torchrun world over gloo")
    args = ap.parse_args(argv)

    do_ast = args.ast_only or not (args.trace_only or args.registry_only)
    do_reg = args.registry_only or not (args.ast_only or args.trace_only)
    do_trace = args.trace_only or not (args.ast_only or args.registry_only)

    findings: list[Finding] = []
    if do_ast:
        print(f"zenlint: AST rules over {args.tree}")
        findings.extend(ast_rules.run_tree(args.tree))
    if do_reg:
        print("zenlint: registry coverage")
        findings.extend(registry_findings(args.tests_dir))
    if do_trace:
        from repro_torch import resolve_device
        device = resolve_device(args.device)
        group = None
        if args.group == "dist":
            from repro_torch.launch.mesh import make_data_group
            group, device = make_data_group("gloo", args.device)
        ns = (tuple(int(x) for x in args.ns.split(",") if x) if args.ns
              else (group.n,) if group is not None else DEFAULT_NS)
        flt = args.schemes.split(",") if args.schemes else None
        print(f"zenlint: trace sweep (R1-R5), n in {ns}, M={args.m}, "
              f"device={device}, group={args.group}")
        try:
            findings.extend(run_trace_sweep(flt, ns, args.m, device=device,
                                            group=group)[0])
        finally:
            if group is not None:
                import torch.distributed as dist
                dist.destroy_process_group()

    for f in findings:
        print(f"FINDING {f}")
    print(f"zenlint: {len(findings)} finding(s) "
          f"[{len(rules.RULES)} trace rules, 3 AST rules] — "
          f"{'FAIL' if findings else 'ok'}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
