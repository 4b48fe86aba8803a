"""The port's zenlint (``repro_torch.analysis``) against the reference's.

* Metadata: the port's registry carries the reference's lint metadata for
  every executable scheme (kinds, saturable, density, caps, the Zen
  routes), and ``wire_words_fn`` at the caps gives the reference's words
  at n 2 and 8 (the port's sweep seeds its Zen layouts with the
  reference sweep's seeds).
* Wire parity: the CPU sweep (every executable scheme x {flat, hier} x n
  {2, 8}, Zen's ``fused-commit`` and ``unfused`` routes, ``run_schedule``)
  is clean, and its recorded bytes per case and group size equal the
  reference's expectation (``repro.analysis.lint._stage_setup`` x 4, no
  lowering) within 1e-6 relative; sparcml's permute-only levels as the
  pooled total, as the reference's R2 holds them.
* One fixture per rule: a sort, an extra all_gather, a float64 cast, an
  encode that reads a collective's output (and an encode issued after the
  commit's first collective), and an ``.item()`` each flag exactly their
  rule (R1-R5), as ``tests/test_zenlint.py`` holds the reference's golden
  modules; the AST fixtures flag exactly AST1-AST3, waivers are honoured,
  and the live port tree is clean.
* The kernel wrappers are opaque to the trace and change no result; the
  CLI never falls back to the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import lint as rlint
from repro.core import registry as rreg
from repro.core import schemes as RS
from repro.core import topology as rtp
from repro_torch.analysis import ast_rules, lint, rules, trace_ir
from repro_torch.core import buckets as bk
from repro_torch.core import registry as preg
from repro_torch.core import schemes as S
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.train import schedule

M, NS = lint.DEFAULT_M, lint.DEFAULT_NS
ROUTE_BACKEND = {"pallas": "cuda", "xla": "torch"}


# ---------------------------------------------------------------------------
# metadata parity
# ---------------------------------------------------------------------------

def _zen_kw(spec, n: int, seeds=None) -> dict:
    """The Zen stage kwargs at the sweep's layout: the port's with
    ``seeds``, else the reference's."""
    budget = min(1.0, 2 * spec.lint_density)
    if seeds is None:
        return {"layout": RS.make_zen_layout(M, n, density_budget=budget)}
    return {"layout": S.make_zen_layout(M, n, density_budget=budget,
                                        seeds=seeds)}


@pytest.mark.parametrize("name", rreg.registered_schemes(executable_only=True))
def test_lint_metadata_equals_the_reference(name):
    ref, port = rreg.get_scheme(name), preg.get_scheme(name)
    for field in ("expected_collectives", "lint_saturable", "lint_density",
                  "lint_exempt"):
        assert getattr(port, field) == getattr(ref, field), field
    for n in NS:
        if ref.lint_caps_fn is None:
            assert port.lint_caps_fn is None
            rkw = _zen_kw(ref, n)
            pkw = _zen_kw(port, n, seeds=lint.LINT_SEEDS)
            assert tuple(int(s) for s in rkw["layout"].seeds) \
                == lint.LINT_SEEDS
            assert pkw["layout"].cap_server == rkw["layout"].cap_server
        else:
            rkw = dict(ref.lint_caps_fn(M, n))
            pkw = dict(port.lint_caps_fn(M, n))
            assert pkw == rkw
        rwords = ref.wire_words_fn(
            M, n, rreg.stage_kwargs(ref, rreg.StageArgs(**rkw)))
        pwords = port.wire_words_fn(
            M, n, preg.stage_kwargs(port, preg.StageArgs(**pkw)))
        assert pwords == rwords, (n, pwords, rwords)
    # each reference route is a port route with the same fields, the
    # reference's pallas backend the port's cuda one
    proutes = dict(port.lint_routes)
    for label, fields in ref.lint_routes:
        want = {k: ROUTE_BACKEND.get(v, v) if k == "backend" else v
                for k, v in fields}
        assert dict(proutes[label]) == want, label


# ---------------------------------------------------------------------------
# the CPU sweep and its wire parity with the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # small ops: threads cost more than they give
    try:
        return lint.run_trace_sweep(verbose=False, device="cpu")
    finally:
        torch.set_num_threads(threads)


def _case(label: str) -> tuple[str, int, bool]:
    scheme = label.split()[0].split("(")[-1].split("@")[0]
    return scheme, int(label.split("n=")[1].split()[0]), \
        label.startswith("hier")


def _reference_bytes(scheme: str, n: int, hier: bool) -> dict[int, float]:
    spec = rreg.get_scheme(scheme)
    sizes = ([lv.size for lv in rtp.build_topology(n, 2).levels
              if lv.size > 1] if hier else [n])
    out: dict[int, float] = {}
    for g in sizes:
        out[g] = out.get(g, 0.0) + rlint._stage_setup(spec, M, g)[1] * 4
    return out


def test_cpu_sweep_is_clean_and_covers_every_case(sweep):
    findings, wires = sweep
    assert not findings, [str(f) for f in findings]
    want = {"run_schedule zen nb=3 flat n=8"}
    for scheme in preg.registered_schemes(executable_only=True):
        spec = preg.get_scheme(scheme)
        for n in NS:
            want.add(f"hier({scheme}@intra,{scheme}@inter) n={n} node=2")
            if spec.feasible(n, M):
                want.add(f"{scheme} flat n={n}")
                want |= {f"{scheme} flat n={n} [{r}]"
                         for r, _ in spec.lint_routes}
    assert set(wires) == want
    assert {"zen flat n=8 [fused-commit]", "zen flat n=2 [unfused]"} <= want


def test_recorded_bytes_equal_the_reference_expectation(sweep):
    _, wires = sweep
    checked = 0
    for label, wire in wires.items():
        if label.startswith("run_schedule"):
            continue
        scheme, n, hier = _case(label)
        want = _reference_bytes(scheme, n, hier)
        got: dict[int, float] = {}
        for (kind, g), b in wire.items():
            assert kind in rreg.get_scheme(scheme).expected_collectives
            got[g] = got.get(g, 0.0) + b
        if rreg.get_scheme(scheme).expected_collectives == \
                ("collective-permute",):   # the reference pools these
            got, want = sum(got.values()), sum(want.values())
            assert abs(got - want) <= 1e-6 * want, label
        else:
            assert set(got) == set(want), label
            for g in want:
                assert abs(got[g] - want[g]) <= 1e-6 * want[g], \
                    (label, g, got[g], want[g])
        checked += 1
    assert checked == len(wires) - 1


def test_routes_record_the_default_routes_bytes(sweep):
    _, wires = sweep
    for n in NS:
        base = wires[f"zen flat n={n}"]
        for route in ("fused-commit", "unfused"):
            assert wires[f"zen flat n={n} [{route}]"] == base


# ---------------------------------------------------------------------------
# one fixture per rule
# ---------------------------------------------------------------------------

N, L = 4, 64


def _x() -> torch.Tensor:
    return torch.as_tensor(lint._payload(L, N, 0.25))


def _psum_subject(body, label: str) -> rules.Subject:
    """A dense-style sync of ``_x()`` (a psum) with ``body(x, rec)`` run
    first, under the trace."""
    x = _x()

    def sync(rec, _tr):
        body(x, rec)
        return rec.psum(x)

    out, records, host = lint.trace_sync(sync, S.SimGroup(N),
                                         torch.device("cpu"))
    assert torch.equal(out[0], x.sum(0))
    want = 2 * (N - 1) / N * L * 4
    return rules.Subject(
        label=label, records=records, host_syncs=host,
        wire={N: rules.WireExpectation(want, want, ("all-reduce",))})


def _pipeline_subject(run, taint: bool, label: str) -> rules.Subject:
    """A 3-bucket encode/commit pipeline; ``taint``: bucket 1's encode
    reads a collective's output."""
    x = _x()

    def sync(rec, tr):
        early = rec.psum(x)

        def encode(b, p):
            with tr.phase("encode", b.bid):
                return p * 2 + (early if taint and b.bid == 1 else 0)

        def commit(b, p):
            with tr.phase("commit", b.bid):
                return rec.psum(p), None

        return run([dataclasses.replace(_BUCKET, bid=i) for i in range(3)],
                   [x] * 3, encode, commit)

    _, records, host = lint.trace_sync(sync, S.SimGroup(N),
                                       torch.device("cpu"))
    return rules.Subject(label=label, records=records, host_syncs=host,
                         expected_fences=2, fences_collective_free=True)


_BUCKET = bk.Bucket(bid=0, kind=bk.DENSE, scheme="dense", slots=(),
                    nbytes=0)


FIXTURES = {
    "clean": (lambda: _psum_subject(lambda x, rec: x * 1.0, "clean"), set()),
    "sort": (lambda: _psum_subject(
        lambda x, rec: torch.argsort(x, dim=-1), "sort"), {"R1"}),
    "extra all_gather": (lambda: _psum_subject(
        lambda x, rec: rec.all_gather(x), "gather"), {"R2"}),
    "f64 cast": (lambda: _psum_subject(
        lambda x, rec: x.double().sum(), "f64"), {"R3"}),
    "pipeline": (lambda: _pipeline_subject(schedule.run_schedule, False,
                                           "pipeline"), set()),
    "encode reads a collective": (lambda: _pipeline_subject(
        schedule.run_schedule, True, "taint"), {"R4"}),
    "encode after the commit": (lambda: _pipeline_subject(
        schedule.run_in_order, False, "in order"), {"R4"}),
    "item": (lambda: _psum_subject(lambda x, rec: x.sum().item(), "item"),
             {"R5"}),
    "bool mask": (lambda: _psum_subject(lambda x, rec: x[x > 1], "mask"),
                  {"R5"}),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_flags_exactly_its_rule(name):
    build, want = FIXTURES[name]
    findings = rules.run_rules(build())
    assert {f.rule for f in findings} == want, [str(f) for f in findings]


def test_lint_exempt_waives_a_rule():
    s = FIXTURES["sort"][0]()
    s.exempt = ("R1",)
    assert rules.run_rules(s) == []


def test_kernel_wrappers_are_opaque_and_change_nothing():
    """The plain scatter-add sorts and calls .item(): under a trace its
    wrapper is one record, on either entry, with the same result."""
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(-1, 40, 300), dtype=torch.int32)
    vals = torch.as_tensor(rng.standard_normal((300, 3)), dtype=torch.float32)
    want = kref.coo_scatter_add_ref(torch.zeros(40, 3), idx, vals)
    for backend in ("cuda", "torch"):
        out = torch.zeros(40, 3)
        with trace_ir.OpTrace() as tr:
            ops.batched_coo_reduce_op(out, idx, vals, backend=backend)
        assert ops.TRACE is None
        assert [r.op for r in tr.records] == ["kernel:coo_scatter_add"]
        assert torch.equal(out, want)
    assert rules.run_rules(rules.Subject("k", records=tr.records)) == []


def test_recording_group_charges_what_each_worker_receives():
    """An all_gather of [n, c] blocks charges (n-1)/n of the gathered
    [n, c] stack to every worker, though SimGroup hands back its input."""
    rec = trace_ir.RecordingGroup(S.SimGroup(N))
    x = torch.zeros(N, 5, dtype=torch.int32)
    assert rec.all_gather(x) is x
    rec.all_to_all(torch.zeros(N, N, 3))
    assert trace_ir.collective_wire(rec) == {
        ("all-gather", N): (N - 1) / N * N * 5 * 4,
        ("all-to-all", N): (N - 1) / N * N * 3 * 4}


# ---------------------------------------------------------------------------
# AST1-AST3 and the CLI
# ---------------------------------------------------------------------------

AST_FIXTURES = {
    "AST1": "import torch.distributed as dist\ndist.all_reduce(x)\n",
    "AST2": "def f(scheme):\n    return scheme == 'zen'\n",
    "AST3": "ap.add_argument('--sync', choices=['zen', 'dense'])\n",
}


@pytest.mark.parametrize("rid", list(AST_FIXTURES))
def test_ast_fixture_flags_exactly_its_rule(rid, tmp_path, monkeypatch):
    src = AST_FIXTURES[rid]
    got = ast_rules.check_source(src, "src/repro_torch/train/fixture.py")
    assert [f.rule for f in got] == [rid]
    line = next(i for i, ln in enumerate(src.splitlines())
                if "all_reduce" in ln or "==" in ln or "choices" in ln)
    lines = src.splitlines()
    lines[line] += f"  # zenlint: ignore[{rid}] a fixture"
    assert ast_rules.check_source("\n".join(lines), "src/repro_torch/x.py") \
        == []
    (tmp_path / "fixture.py").write_text(src)
    monkeypatch.chdir(tmp_path)
    assert lint.main(["--ast-only", "--tree", "."]) == 1


def test_ast1_allows_the_group_classes():
    src = AST_FIXTURES["AST1"]
    for path in ast_rules.COLLECTIVE_ALLOWED:
        assert ast_rules.check_source(src, path) == []


def test_live_tree_and_registry_are_clean(monkeypatch):
    monkeypatch.chdir(lint.__file__.rsplit("/src/", 1)[0])
    assert ast_rules.run_tree("src/repro_torch") == []
    assert lint.registry_findings("tests") == []
    assert lint.main(["--trace-only", "--device", "cpu", "--schemes",
                      "dense,agsparse", "--ns", "2", "--m", "256"]) == 0


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.main(["--trace-only", "--schemes", "dense"])
