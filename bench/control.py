"""The readings a training cell's limits are set from, at the cell's own
size (not part of a benchmark run):

    python3 bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --out readings.json

In one process: the program is built once and, for each seed, given that
seed's weights and a fresh optimizer state and driven through the cell's
first steps (``runners/train.py``'s check steps); for each fault seed the
same again under each planted fault (``harness/faults.py``).  The
program is then freed, and the reference follows each seed's steps in
float32 and, for each control seed, in float8 (the control: the
reference in the program's place, one precision below the
configuration's bf16).  Every reading is compared with the float32
reference's of its seed (``trainref.compare``) and written to ``--out``
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def collect(workload: str, seeds, control_seeds, fault_seeds, *,
            device="cuda", backend="cuda", bench: Path = BENCH,
            steps: int | None = None) -> dict:
    """Every reading of the seeds; ``steps`` (default the mix's check
    steps) fewer where only the first step's numbers are wanted."""
    import torch

    from harness import faults, spec, trainref

    cell = spec.Cell(workload, bench)
    drv = cell.runner()
    prog, dm = drv.build(cell, device, backend)
    from repro_torch.core.zen import GradSync

    opt = cell.traffic["optimizer"]
    steps = steps or drv.CHECK_STEPS
    prog_r: dict = {}
    fault_r: dict = {k: {} for k in faults.FAULTS}
    t0 = time.time()
    for seed in seeds:
        drv.load_weights(prog, dm, seed)
        drv.reset_state(prog)
        prog_r[seed] = drv.check_steps(prog, dm, drv.feed(cell, dm, seed,
                                                           prog.device),
                                       seed, opt, steps)
    for name, fault in faults.FAULTS.items():
        for seed in fault_seeds:
            drv.load_weights(prog, dm, seed)
            drv.reset_state(prog)
            with fault(GradSync):
                fault_r[name][seed] = drv.check_steps(
                    prog, dm, drv.feed(cell, dm, seed, prog.device), seed,
                    opt, steps)
    t_prog = time.time() - t0
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    model = cell.reference()
    t0 = time.time()
    ref = {s: trainref.readings(model, dm, cell.traffic, s, device,
                                steps=steps)
           for s in sorted(set(seeds) | set(control_seeds) | set(fault_seeds))}
    ctl = {s: trainref.readings(model, dm, cell.traffic, s, device,
                                precision="fp8", steps=steps)
           for s in control_seeds}
    t_ref = time.time() - t0

    def gaps(r: dict) -> dict:
        out = {}
        for s, x in r.items():
            c = trainref.compare(x, ref[s])
            out[s] = {**{k: v[0] for k, v in c.items()},
                      **{f"{k}_at": v[1] for k, v in c.items()},
                      "loss_gaps": trainref.loss_gaps(x, ref[s]), "raw": x}
        return out

    out = {"workload": workload, "device": (torch.cuda.get_device_name()
                                            if device == "cuda" else "cpu"),
           "power": _power() if device == "cuda" else "",
           "program": gaps(prog_r), "control": gaps(ctl),
           "faults": {k: gaps(v) for k, v in fault_r.items()},
           "reference": ref,
           "seconds": {"program": t_prog, "reference": t_ref}}
    for kind in ("program", "control"):
        for k in ("grad_gap", "change_gap"):
            vals = [g[k] for g in out[kind].values()]
            if vals:
                out.setdefault("summary", {})[f"{kind}.{k}"] = [min(vals),
                                                                max(vals)]
    for f, r in out["faults"].items():
        for k in ("grad_gap", "change_gap"):
            vals = [g[k] for g in r.values()]
            if vals:
                out["summary"][f"{f}.{k}"] = [min(vals), max(vals)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = collect(args.workload, _seeds(args.seeds),
                  _seeds(args.control_seeds), _seeds(args.fault_seeds),
                  steps=args.steps)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out["summary"], indent=1))
    print(json.dumps(out["seconds"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
