"""Glue: build a train program for an architecture and a mesh (port of the
parts of ``repro.train.build`` the trainer needs)."""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import Model
from repro_torch.train import steps as st
from repro_torch.train.steps import TrainerConfig


def parse_mesh(mesh: str | Sequence[int]) -> tuple[int, int]:
    """'DxM' (or a (D, M) tuple) -> (data-parallel D, tensor-parallel M).
    A pod axis ('PxDxM') and M > 1 are not ported yet."""
    dims = ([int(x) for x in mesh.split("x")] if isinstance(mesh, str)
            else [int(x) for x in mesh])
    if len(dims) == 3:
        raise NotImplementedError(
            "pod meshes (PxDxM): ROADMAP queue 1, item 9 (two-level "
            "topologies)")
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"mesh must be DxM with positive sizes, got {mesh!r}")
    if dims[1] != 1:
        raise NotImplementedError(
            f"tensor parallelism (mesh {mesh!r}, M={dims[1]}): ROADMAP queue "
            f"1, item 9; the port runs Dx1 meshes")
    return dims[0], dims[1]


@dataclasses.dataclass
class Program:
    """A model and its trainer on one device; the D data-parallel ranks of
    the mesh are held in this one process."""

    cfg: ArchConfig
    model: Model
    tcfg: TrainerConfig
    n_data: int
    device: torch.device
    train_step: Any = None
    gradsync: Any = None


def build_program(cfg: ArchConfig, mesh, tcfg: TrainerConfig | None = None,
                  *, device=None, seed: int = 0) -> Program:
    """Model (initialised from ``seed`` with a torch.Generator) on
    ``device`` (default ``cuda``; ``"cpu"`` must be asked for)."""
    dp, _ = parse_mesh(mesh)
    dev = resolve_device(device)
    model = Model(cfg, device=dev, seed=seed)
    return Program(cfg=cfg, model=model, tcfg=tcfg or TrainerConfig(),
                   n_data=dp, device=dev)


def attach_train(prog: Program) -> None:
    """Build ``prog.train_step(batch) -> metrics`` and its GradSync."""
    prog.gradsync = st.make_gradsync(prog.model, prog.tcfg, prog.n_data)
    prog.train_step = st.make_train_step(prog.model, prog.tcfg, prog.n_data,
                                         gradsync=prog.gradsync)
