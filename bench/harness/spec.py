"""Finding a cell's files by name: its workload, configuration, traffic mix,
runner, reference and per-layer metric readers, all under one bench
directory (``bench/`` by default; a test points it at a copy)."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str, what: str) -> str:
    """``name`` if it is a benchmark name (letters, digits, ``_ . -``, at
    most 64, no leading ``.`` or ``-``), else ValueError."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def _json(bench: Path, folder: str, name: str, what: str) -> dict:
    path = bench / folder / f"{check_name(name, what)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as a fresh module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(bench: Path, folder: str, name: str, what: str) -> ModuleType:
    path = bench / folder / f"{check_name(name, what)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r}: {path} is missing")
    return load_module(path, f"bench_{folder}_{name.replace('.', '_')}")


class Cell:
    """One cell: ``workload`` (its file), ``config`` and ``traffic`` (theirs)
    and the names of each."""

    def __init__(self, name: str, bench: Path = BENCH):
        self.bench = Path(bench)
        self.name = name
        self.workload = _json(self.bench, "workloads", name, "workload")
        self.config_name = self.workload["config"]
        self.traffic_name = self.workload["traffic"]
        self.config = _json(self.bench, "configs", self.config_name, "config")
        self.traffic = _json(self.bench, "traffic", self.traffic_name,
                             "traffic")
        self.limits = dict(self.workload["limits"])

    def runner(self) -> ModuleType:
        """``runners/<traffic kind>.py``: runs the mix on the program."""
        return _module(self.bench, "runners", self.traffic["kind"], "runner")

    def reference(self) -> ModuleType:
        """``reference/<config reference>.py``: the plain reference."""
        return _module(self.bench, "reference", self.config["reference"],
                       "reference")


def metric_readers(bench: Path = BENCH) -> dict[str, ModuleType]:
    """{metric name: reader module} for every ``metrics/<name>.py``; each
    has ``UNIT``, ``MOVES`` and ``read(record) -> float | None``."""
    out = {}
    for path in sorted((Path(bench) / "metrics").glob("*.py")):
        out[path.stem] = _module(Path(bench), "metrics", path.stem, "metric")
    return out
