"""The harness end to end at a tiny size on the CPU (the port's plain
route), a cell added as files alone, the reference against the port, the
control, and the refusals of the command."""
import hashlib
import json
import math
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(BENCH))

from harness import spec, trainref  # noqa: E402

RUN = spec.load_module(BENCH / "run.py", "bench_run_under_test")
# the tiny cells' limits, set from the CPU's readings over 12 seeds and
# its control and faults on 3 (PERF.md, section 6)
TINY = {
    "tiny.dp8": ("tiny", "tiny-dp8", {"grad_gap": 0.03, "change_gap": 0.4}),
    "tiny-hd64.dp8": ("tiny-hd64", "tiny-dp8",
                      {"grad_gap": 0.03, "change_gap": 0.35}),
}
SEED = 2**33 + 101


def bench_copy(dest: Path) -> Path:
    """A copy of ``bench/`` (without its tests) with the tiny cells' files
    added: configurations and mixes from ``tests/data``, workloads with
    their limits."""
    out = dest / "bench"
    shutil.copytree(BENCH, out, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for folder in ("configs", "traffic"):
        for f in (DATA / folder).glob("*.json"):
            shutil.copy(f, out / folder / f.name)
    for name, (config, traffic, limits) in TINY.items():
        (out / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": config, "traffic": traffic, "chips": 1,
             "why": "a test's size", "limits": limits}))
    return out


@pytest.fixture
def tiny_bench(tmp_path):
    return bench_copy(tmp_path)


def run_tiny(bench, name="tiny.dp8", seed=SEED, trace=False):
    return RUN.run_cell(name, seed, 0.2, trace, device="cpu",
                        backend="torch", bench=bench)


def _digests(folder: Path) -> dict:
    return {p.relative_to(folder).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("name", ["tiny.dp8", "tiny-hd64.dp8"])
def test_a_run_gives_the_contract_line(tiny_bench, name):
    r = run_tiny(tiny_bench, name)
    readings = r.pop("_readings")
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 4
    assert {k: v["unit"] for k, v in r["metrics"].items()} == {
        "train_tokens_per_s": "tokens/s", "peak_gib": "GiB", "setup_s": "s"}
    assert all(v["value"] > 0 for k, v in r["metrics"].items()
               if k != "peak_gib")
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    line = json.dumps(RUN._finite(r))
    assert json.loads(line)["checks"] == r["checks"]
    # the reference follows the port's three steps from the same inputs
    lp, lr = readings["program"]["loss"], readings["reference"]["loss"]
    assert len(lp) == len(lr) == 3
    assert all(abs(a - b) < 1e-2 for a, b in zip(lp, lr))
    assert set(readings["program"]["grad"]) == set(readings["reference"]
                                                   ["grad"])


def test_a_traced_run_on_the_cpu_reports_no_device_metric(tiny_bench):
    r = run_tiny(tiny_bench, trace=True)
    r.pop("_readings")
    assert r["correct"] is True
    assert r["metrics"] == {} and "breakdown" not in r
    assert "busy_s" not in r["device"]


def test_a_new_cell_is_files_alone(tiny_bench):
    before = _digests(tiny_bench)
    (tiny_bench / "traffic" / "dummy-mix.json").write_text(json.dumps(
        dict(json.loads((DATA / "traffic" / "tiny-dp8.json").read_text()),
             batch_per_rank=1, seq_len=16)))
    (tiny_bench / "workloads" / "tiny.dummy-mix.json").write_text(
        json.dumps({"config": "tiny", "traffic": "dummy-mix", "chips": 1,
                    "why": "a cell added by its files",
                    "limits": TINY["tiny.dp8"][2]}))
    r = run_tiny(tiny_bench, "tiny.dummy-mix")
    assert r["correct"] is True
    assert r["metrics"]["train_tokens_per_s"]["value"] > 0
    after = _digests(tiny_bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/dummy-mix.json",
                                        "workloads/tiny.dummy-mix.json"}


@pytest.mark.parametrize("name", ["tiny.dp8", "tiny-hd64.dp8"])
def test_the_control_fails_the_tiny_cells(tiny_bench, name):
    """The reference in the program's place, its products in float8: it
    fails at least one number that the port passes."""
    cell = spec.Cell(name, tiny_bench)
    from harness import inputs
    dm = inputs.dims(cell.config)
    model = cell.reference()
    ref = trainref.readings(model, dm, cell.traffic, SEED, "cpu")
    ctl = trainref.readings(model, dm, cell.traffic, SEED, "cpu",
                            precision="fp8")
    gaps = trainref.compare(ctl, ref)
    assert any(gaps[k][0] > v for k, v in cell.limits.items())


def test_the_gaps_take_the_worst_leaf_against_the_median():
    ref = {"loss": [2.0, 1.0],
           "grad": {"a": 1.0, "b": 2.0, "c": 1e-9, "d": 0.01},
           "change": {"a": 1.0, "b": 2.0, "c": 5.0, "d": 0.5}}
    prog = {"loss": [2.02, 1.0],
            "grad": {"a": 1.1, "b": 2.0, "c": 0.5, "d": 0.012},
            "change": {"a": 1.0, "b": 2.2, "c": 0.0, "d": 0.5}}
    g = trainref.compare(prog, ref)
    assert trainref.loss_gaps(prog, ref) == [pytest.approx(0.01), 0.0]
    # d is small against the median leaf (0.505) but moves: its gap is
    # over its own norm, 0.002 / 0.01; c's reference gradient is under a
    # thousandth of the median's, round-off: it is left out of both
    assert g["grad_gap"] == (pytest.approx(0.2), "d")
    assert g["change_gap"] == (pytest.approx(0.1), "b")
    bad = dict(prog, loss=[2.0, math.nan])
    assert all(v[0] == math.inf
               for v in trainref.compare(bad, ref).values())


def test_the_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = RUN.main(["--workload", "qwen2-0.5b.dp8-s4096", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_the_command_refuses_without_the_port(tmp_path, capsys,
                                              monkeypatch):
    """A directory with only BENCHMARK.json and the benchmark's paths."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = spec.load_module(tmp_path / "bench" / "run.py", "bench_run_bare")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ImportError):
        run.main(["--workload", "qwen2-0.5b.dp8-s4096", "--seed", "1",
                  "--seconds", "1"])
    assert capsys.readouterr().out == ""


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert "repro_torch" not in str(RUN.forbidden_modules())
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    monkeypatch.setitem(sys.modules, "jaxlib_like",
                        types.ModuleType("jaxlib_like"))
    assert RUN.forbidden_modules() == sorted(
        m for m in sys.modules if m.split(".")[0] in RUN.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core.fake",
                        types.ModuleType("repro.core.fake"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    bad = RUN.forbidden_modules()
    assert "repro.core.fake" in bad and "flax" in bad
    assert "reprox" not in bad and "jaxlib_like" not in bad


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tmp_path):
    """The kernel route at a tiny size with the card's head width (64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    bench = bench_copy(tmp_path)
    r = RUN.run_cell("tiny-hd64.dp8", SEED, 0.5, True, device="cuda",
                     backend="cuda", bench=bench)
    r.pop("_readings")
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"idle_share", "sync_ms", "flash_fwd_roofline",
            "zen_roofline"} <= set(r["metrics"])
    assert 0 < r["metrics"]["flash_fwd_roofline"]["value"] <= 105
