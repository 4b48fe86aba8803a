"""The benchmark of the PyTorch port (``repro_torch``):

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port under ``src/``.  It finds
the cell's files by name under ``bench/`` (``harness/__init__.py``),
runs the cell's runner on one CUDA card, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number compared with its limit, which also end standard error.

It exits non-zero and prints no result without a CUDA card, without the
port under ``src/``, or when JAX, flax or the JAX package ``repro`` is
loaded once the run is over.  Build outputs stay inside the checkout
(``build/repro_torch/``, the port's kernel build directory).
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _port_path() -> None:
    """Put the checkout's ``src`` first on the path and make sure the port
    comes from there."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        raise ImportError(f"repro_torch comes from {where}, not from the "
                          f"checkout's src/")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", backend: str = "cuda", bench: Path = BENCH,
             t_process: float | None = None) -> dict:
    """One run of ``workload``: the result's dict, in the printed order.
    ``device="cpu"`` with ``backend="torch"`` is the plain path the tests
    drive; the command always runs on the card."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec, trainref

    cell = spec.Cell(workload, bench)
    out = cell.runner().run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device, backend=backend,
                            t_process=time.time() if t_process is None
                            else t_process)
    gaps = trainref.compare(out["program"], out["reference"])
    checks = {}
    for name, (value, where) in gaps.items():
        checks[name] = {"value": value, "limit": cell.limits[name],
                        "at": where}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and out["failed"] == 0
    import torch
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    rec = out["record"]
    if trace:
        metrics = {}
        if rec is not None:
            for name, reader in spec.metric_readers(bench).items():
                value = reader.read(rec)
                if value is not None:
                    metrics[name] = {"value": value, "unit": reader.UNIT}
            dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out["metrics"].items()}
    result.update(metrics=metrics, device=dev)
    if trace and rec is not None:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    result["_readings"] = {"program": out["program"],
                           "reference": out["reference"]}
    return result


def _finite(x):
    """``x`` with every non-finite float as None (JSON has no infinity)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(BENCH))
    from harness import spec
    need = spec.Cell(args.workload).workload["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: the cell needs {need} CUDA card(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    _port_path()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=T_PROCESS)
    result.pop("_readings")
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"(at {c['at']})", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
