"""The plain reference of a data-parallel training step, and the readings
that decide ``correct`` for a training cell.

The reference follows the first ``steps`` steps of the cell from the same
inputs as the program (``inputs.weights`` and ``inputs.Batches`` from the
seed), written from the semantics the cell states, not from the port:

1. each of the ``ranks`` data ranks takes its contiguous rows of the
   global batch; its loss is the mean over its tokens and its gradient is
   taken in float32 (the configuration's model, ``reference/<name>.py``,
   one sequence at a time);
2. the sync gives every rank the mean of the ranks' gradients;
3. the global-norm clip, then AdamW on every leaf in float32, the new
   values stored in the leaf's storage dtype.

Readings, the same on both sides: each step's loss (the mean over every
rank's tokens), the norm of each leaf's first gradient as the optimizer
gets it (after the clip), and the norm of each leaf's change after the
steps.  :func:`compare` sets them side by side.
"""
from __future__ import annotations

import math
import statistics

import torch

from harness import inputs


@torch.no_grad()
def _adamw(p, g, m, v, step: int, opt: dict):
    m.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
    v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
    t = step + 1.0
    mh = m / (1 - opt["b1"] ** t)
    vh = v / (1 - opt["b2"] ** t)
    pf = p.float()
    upd = mh / (torch.sqrt(vh) + opt["eps"]) + opt["weight_decay"] * pf
    p.copy_((pf - opt["lr"] * upd).to(p.dtype))


def readings(model, dm, traffic: dict, seed: int, device, *,
             precision: str = "f32", steps: int = 3) -> dict:
    """The reference's readings over the first ``steps`` steps of the
    cell: ``loss`` [steps], ``grad`` and ``change`` {leaf: norm}."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _readings(model, dm, traffic, seed, device, precision, steps)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _readings(model, dm, traffic, seed, device, precision, steps):
    ranks = traffic["data_ranks"]
    rows = traffic["batch_per_rank"]
    opt = traffic["optimizer"]
    leaves = inputs.leaves(dm)
    names = [lf.name for lf in leaves]
    w0 = inputs.weights(dm, seed, device)
    params = {n: w0[n].clone() for n in names}
    mom = {n: (torch.zeros(params[n].shape, device=device),
               torch.zeros(params[n].shape, device=device)) for n in names}
    batches = inputs.Batches(dm.vocab, ranks * rows, traffic["seq_len"],
                             traffic["zipf"], seed, device)
    losses, grad = [], None
    for step in range(steps):
        batch = batches(step)
        pf = {n: params[n].to(torch.float32, copy=True).requires_grad_()
              for n in names}
        gsum = {n: torch.zeros_like(pf[n]) for n in names}
        total = torch.zeros((), device=device)
        for r in range(ranks):
            for row in range(r * rows, (r + 1) * rows):
                loss = model.row_loss(pf, batch["tokens"][row],
                                      batch["labels"][row], dm, precision)
                (loss / rows).backward()
                total += loss.detach()
            with torch.no_grad():
                for n in names:
                    gsum[n] += pf[n].grad
                    pf[n].grad = None
        losses.append(float(total) / (ranks * rows))
        with torch.no_grad():
            for x in gsum.values():   # the mean, clipped, in place
                x.div_(ranks)
            gn = torch.sqrt(sum((x * x).sum() for x in gsum.values()))
            if opt["grad_clip"] > 0:
                scale = torch.clamp(opt["grad_clip"] / (gn + 1e-9), max=1.0)
                for x in gsum.values():
                    x.mul_(scale)
            if step == 0:
                grad = {n: float(gsum[n].norm()) for n in names}
            for n in names:
                _adamw(params[n], gsum[n], *mom[n], step, opt)
        del pf, gsum
    change = {n: float((params[n].float() - w0[n].float()).norm())
              for n in names}
    return {"loss": losses, "grad": grad, "change": change}


def _gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """The worst of ``leaves``' gaps |prog - ref| over ref's norm of the
    same leaf, and that leaf."""
    worst = (-math.inf, "")
    for n in leaves:
        gap = abs(prog.get(n, math.nan) - ref[n]) / ref[n]
        worst = max(worst, (gap if math.isfinite(gap) else math.inf, n))
    return worst


# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone, in its gradient and under Adam in its
# change (a key's bias under softmax): it is left out of both comparisons
MOVED = 1e-3


def loss_gaps(prog: dict, ref: dict) -> list[float]:
    """Each step's relative gap of the loss (infinite where the program's
    is not finite or a step is missing)."""
    lp, lr = prog["loss"], ref["loss"]
    gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(lp, lr)]
    return gaps + [math.inf] * (len(lr) - len(gaps))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, each with the leaf it is read at:
    ``grad_gap`` and ``change_gap``, the worst leaf's gap of norms, each
    over the reference's norm of that leaf (:func:`_gap`), over the leaves
    whose reference gradient is at least ``MOVED`` of the median leaf's.
    A step whose loss is not finite makes both infinite.  The losses are
    read and not compared (:func:`loss_gaps`; PERF.md section 6 gives
    why)."""
    bad = any(not math.isfinite(g) for g in loss_gaps(prog, ref))
    med = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= MOVED * med]
    out = {"grad_gap": _gap(prog["grad"], ref["grad"], moved),
           "change_gap": _gap(prog["change"], ref["change"], moved)}
    if bad:
        out = {k: (math.inf, "a loss") for k in out}
    return out
