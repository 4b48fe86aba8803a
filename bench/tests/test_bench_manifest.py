"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, mix and per-layer metric it names found by name under
``bench/``."""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import inputs, spec  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# widths, which no cut may name
WIDTHS = ("hidden_size", "intermediate_size", "head_dim", "num_attention_heads",
          "num_key_value_heads", "vocab_size")


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"])
            assert (ROOT / w).is_file()
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check at 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and key != "source":
                assert _line(e[key]), (e["name"], key)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert len(e2e) >= 2
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_are_reader_files():
    readers = spec.metric_readers(BENCH)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    listed = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert set(readers) == set(listed)
    for name, m in listed.items():
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert readers[name].UNIT == m["unit"]
        assert readers[name].MOVES == m["moves"]
        if name.endswith("_roofline") or "mfu" in name:
            assert m["unit"] == "%"
    layers = {m["layer"] for m in listed.values()}
    assert layers == {"device", "train step", "host", "GradSync", "model",
                      "kernels"}


def test_configs_are_files_with_their_cuts():
    seen = set()
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert c["file"] not in seen
        seen.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
            assert key in data["published"], key
            assert data.get(key) != data["published"][key], key
        assert (BENCH / "reference" / f"{data['reference']}.py").is_file()
        inputs.dims(data)          # every size the runner reads is there


def test_workloads_are_files_and_agree():
    pairs = set()
    for w in MANIFEST["workloads"]:
        cell = spec.Cell(w["name"], BENCH)
        assert cell.config_name == w["config"]
        assert cell.traffic_name == w["traffic"]
        assert cell.workload["chips"] == w["chips"] == 1
        assert cell.workload["why"] == w["why"] and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert set(cell.limits) == {"grad_gap", "change_gap"}
        assert all(0 < v < 1 for v in cell.limits.values())
        assert cell.runner().run and cell.reference().row_loss
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)


def test_bench_files_are_named_from_names():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
