"""Glue: build a train or serve program for an architecture and a mesh
(port of the parts of ``repro.train.build`` the trainer and the server
need).  A mesh is ``DxM`` or ``PxDxM`` (P pods of D data-parallel ranks,
M tensor-parallel ranks each); ``node_size`` splits D into nodes (a
two-level topology, ``launch/mesh.py`` lays the ranks out).  M > 1 runs
one process per rank (``launch/mesh.make_mesh_groups``) for every model
kind, beside pods and nodes too; the model axis held in one process
raises naming ROADMAP queue 1, item 9."""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.schemes import DistGroup, SimGroup
from repro_torch.launch.mesh import check_node_size
from repro_torch.models.common import ArchConfig, make_ctx
from repro_torch.models.model import Model
from repro_torch.train import steps as st
from repro_torch.train.steps import TrainerConfig


def parse_mesh(mesh: str | Sequence[int]) -> tuple[int, int, int]:
    """'DxM' or 'PxDxM' (or a tuple) -> (pods P, data-parallel D,
    tensor-parallel M), P = 1 for 'DxM'."""
    dims = ([int(x) for x in mesh.split("x")] if isinstance(mesh, str)
            else [int(x) for x in mesh])
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"mesh must be DxM or PxDxM with positive sizes, "
                         f"got {mesh!r}")
    pods, dp, tp = [1] * (3 - len(dims)) + dims
    return pods, dp, tp


def check_tp(mesh, model_group=None) -> None:
    """What M > 1 does not run raises ``NotImplementedError`` naming
    ROADMAP queue 1, item 9: the model axis held in one process (no model
    group)."""
    pods, dp, tp = parse_mesh(mesh)
    if tp > 1 and model_group is None:
        raise NotImplementedError(
            f"tensor parallelism (mesh {mesh!r}, M={tp}) runs one process "
            f"per rank: start it with `torchrun --standalone "
            f"--nproc-per-node {pods * dp * tp} -m repro_torch.launch.train "
            f"--mesh {mesh} --dist gloo ...` (or nccl, a GPU a rank); "
            f"holding the model axis in one process is not built (ROADMAP "
            f"queue 1, item 9)")


@dataclasses.dataclass
class Program:
    """A model and its trainer or server on one device.  ``group`` holds
    the mesh's P x D ranks (pod-major): all of them in this process
    (``SimGroup``), or this process's one rank of a ``torch.distributed``
    group (``DistGroup``; under tensor parallelism the data group of the
    ranks that share this rank's model index, and ``model.ctx.group`` its
    model group).  ``n_data`` is D, ``pods`` P, and ``node_size`` the
    ranks of a node (1: the flat topology)."""

    cfg: ArchConfig
    model: Model
    tcfg: TrainerConfig
    n_data: int
    device: torch.device
    group: SimGroup | DistGroup
    node_size: int = 1
    pods: int = 1
    train_step: Any = None
    gradsync: Any = None
    prefill_step: Any = None
    decode_step: Any = None
    # the decode cache's batch, length and attention window (attach_serve)
    cache_specs: Any = None
    # the measured profiles the train step's GradSync was planned from
    sparsity_profiles: Any = None

    @property
    def model_group(self) -> DistGroup | None:
        """The model group (None at M = 1)."""
        return self.model.ctx.group

    def opt_state(self) -> dict:
        """The trainer's optimizer state (``train_step.state``: moments,
        under ZeRO-1 this process's ``[local, c]`` chunks of each leaf's,
        step and, with EF compression, the residuals), what a checkpoint
        holds beside the parameters."""
        if self.train_step is None:
            if self.tcfg.sync.compress != "none":
                raise ValueError(
                    "EF compression sizes the residual from the bucket plan: "
                    "call attach_train(prog) before opt_state")
            raise ValueError("call attach_train(prog) before opt_state")
        return self.train_step.state

    def fresh_cache(self) -> dict:
        """An empty decode cache (zeros, every slot's position -1, t = 0)
        for the shape of the last ``attach_serve(..., mode="decode")``."""
        if self.cache_specs is None:
            raise ValueError("fresh_cache needs attach_serve(prog, ..., "
                             "mode='decode') first")
        return self.model.make_cache(self.cache_specs["batch"],
                                     self.cache_specs["cache_len"])


def build_program(cfg: ArchConfig, mesh, tcfg: TrainerConfig | None = None,
                  *, device=None, seed: int = 0, backend: str = "cuda",
                  group: SimGroup | DistGroup | None = None,
                  node_size: int = 1, model_group: DistGroup | None = None,
                  pad_heads: bool = False, moe_a2a: bool = False) -> Program:
    """Model (initialised from ``seed`` with a torch.Generator) on
    ``device`` (default ``cuda``; ``"cpu"`` must be asked for), its
    prefill kernels on the ``backend`` route (``Model``).  ``group``
    (default ``SimGroup(P x D)``) must have the mesh's P x D ranks; on a
    ``DistGroup`` every rank then takes rank 0's parameters, as DDP does.
    ``node_size`` must divide D.  A mesh with M > 1 needs ``model_group``
    (the M ranks of this rank's model group, ``make_mesh_groups``) and
    builds this rank's shards under the reference's ``make_ctx``
    (``pad_heads``, ``moe_a2a``)."""
    pods, dp, tp = parse_mesh(mesh)
    check_node_size(dp, node_size)
    check_tp(mesh, model_group)
    if group is not None and group.n != pods * dp:
        pods_ = f" in each of {pods} pods" if pods > 1 else ""
        raise ValueError(f"mesh {mesh!r} has D={dp} data-parallel ranks"
                         f"{pods_} but the process group has {group.n}")
    if tp > 1 and model_group.n != tp:
        raise ValueError(f"mesh {mesh!r} has M={tp} model ranks but the "
                         f"model group has {model_group.n}")
    ctx = make_ctx(cfg, tp, dp, pods, pad_heads=pad_heads, moe_a2a=moe_a2a,
                   node_size=node_size, group=model_group)
    dev = resolve_device(device)
    model = Model(cfg, device=dev, seed=seed, backend=backend, ctx=ctx)
    group = group or SimGroup(pods * dp)
    group.broadcast_(list(model.parameters()))
    return Program(cfg=cfg, model=model, tcfg=tcfg or TrainerConfig(),
                   n_data=dp, device=dev, group=group, node_size=node_size,
                   pods=pods)


def attach_train(prog: Program, sparsity_profiles=None) -> None:
    """Build ``prog.train_step(batch) -> metrics`` and its GradSync over
    ``prog.group``.

    ``sparsity_profiles`` ({bucket key or leaf name: SparsityProfile})
    feeds measured density curves into the ``auto`` scheme's per-bucket
    choice: the DensityController's replan calls attach_train again with
    the profiles it has learned.  A train step already attached hands its
    optimizer state (moments, step, EF residuals) to the new one: bucket
    boundaries and residual shapes do not depend on schemes."""
    old = prog.gradsync
    prog.sparsity_profiles = sparsity_profiles
    prog.gradsync = st.make_gradsync(prog.model, prog.tcfg, prog.n_data,
                                     prog.group, sparsity_profiles,
                                     node_size=prog.node_size, pods=prog.pods)
    state = None
    if prog.train_step is not None:
        if old.compressed_buckets() != prog.gradsync.compressed_buckets():
            raise ValueError("attach_train: the rebuilt plan's compressed "
                             "buckets differ from the live one's")
        state = prog.train_step.state
    prog.train_step = st.make_train_step(prog.model, prog.tcfg, prog.n_data,
                                         gradsync=prog.gradsync, state=state)


def attach_serve(prog: Program, seq_len: int, global_batch: int,
                 mode: str) -> None:
    """Build ``prog.prefill_step`` (``mode="prefill"``) or
    ``prog.decode_step`` and the decode cache's shape (``"decode"``) for
    ``global_batch`` sequences of ``seq_len`` tokens (a VLM's cache also
    holds its ``n_patches`` prefix positions; an encoder-decoder's each
    layer's cross cache of ``enc_len`` frames).  Decode attends to a
    sliding window only above 65536 tokens, as the reference does."""
    if mode == "prefill":
        prog.prefill_step = st.make_prefill_step(prog.model)
        return
    if mode != "decode":
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if prog.cfg.kind == "vlm":
        seq_len += prog.cfg.n_patches
    window = prog.cfg.sliding_window if seq_len > 65536 else 0
    prog.decode_step = st.make_decode_step(prog.model, window=window)
    prog.cache_specs = {"batch": global_batch, "window": window,
                        "cache_len": min(seq_len, window) if window
                        else seq_len}
