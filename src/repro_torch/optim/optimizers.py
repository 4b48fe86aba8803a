"""AdamW and SGD on parameter tensors (port of ``repro.optim.optimizers``).

The updates run elementwise in f32, in place, on whatever they are given:
the full leaf (``--no-zero1``) or, under ZeRO-1 (``train/steps.py``), each
rank's flat f32 chunk of it, so both give the same numbers, as in the
reference.  The EF
residual (``core/sparsify.py``) is optimizer state too:
:func:`ef_residual_init` makes it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"      # adamw | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0   # global-norm clip (0 = off)


def adamw_init(p: torch.Tensor) -> dict:
    return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, p: torch.Tensor, g: torch.Tensor,
                 st: dict, step: int) -> None:
    """In-place AdamW step ``step`` (0-based) of leaf ``p`` with gradient
    ``g``; the moments ``st`` are f32 and updated in place."""
    g = g.float()
    pf = p.float()
    st["m"].mul_(cfg.b1).add_((1 - cfg.b1) * g)
    st["v"].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    t = float(step) + 1.0
    mh = st["m"] / (1 - cfg.b1 ** t)
    vh = st["v"] / (1 - cfg.b2 ** t)
    upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
    p.copy_((pf - cfg.lr * upd).to(p.dtype))


def sgd_init(p: torch.Tensor) -> dict:
    return {"mom": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}


@torch.no_grad()
def sgd_update(cfg: OptConfig, p: torch.Tensor, g: torch.Tensor, st: dict,
               step: int) -> None:
    """In-place SGD with momentum 0.9 (the reference's): ``mom = 0.9 mom +
    g`` in f32, ``p -= lr mom``."""
    del step
    st["mom"].mul_(0.9).add_(g.float())
    p.copy_((p.float() - cfg.lr * st["mom"]).to(p.dtype))


INITS = {"adamw": adamw_init, "sgd": sgd_init}
UPDATES = {"adamw": adamw_update, "sgd": sgd_update}


def ef_residual_init(sizes: dict[str, tuple], device) -> dict:
    """Zero error-feedback residual memory: one f32 tensor of each shape in
    ``sizes`` (``{bucket key: (local ranks, elements)}``) on ``device``.

    Like the moments it is optimizer state (checkpointed with them, updated
    every step), but it is per rank and never ZeRO-chunked: compression
    consumes the rank's own bucket payload before any update."""
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k, shape in sizes.items()}
