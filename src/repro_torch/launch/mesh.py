"""The data-parallel process group (counterpart of ``repro.launch.mesh``).

The reference runs its train step as one SPMD program per device of a JAX
mesh.  The port's counterpart is one process per data-parallel rank,
started by ``torchrun``, on a ``torch.distributed`` group:

    torchrun --standalone --nproc-per-node D -m repro_torch.launch.train \\
        --mesh Dx1 --dist gloo ...

``gloo`` runs on the CPU and on CUDA tensors (staged through host memory
by gloo itself), and it lets several ranks share one card, so a machine
with one GPU runs the D ranks side by side on it.  ``nccl`` places one
rank on each card and refuses two ranks on one; asking for it where the
ranks outnumber the cards raises rather than quietly switching to gloo.

Two-level data parallelism (``--node-size k``) and pods (``--mesh
PxDx1``) lay the P x D ranks out pod-major, and a node's k ranks are
CONSECUTIVE (the reference's ``launch/mesh.py`` grouping):
:func:`make_level_groups` makes one ``torch.distributed`` group per node
(ranks ``[j*k, ..., j*k + k - 1]``), per cross-node column (``[i, i + k,
...]``) and per pod column, every rank making every group in one order.

Tensor parallelism (``--mesh DxM``, M > 1) lays the world out as the
reference's mesh ``(data, model)``, model innermost: rank ``d M + m``.
:func:`make_mesh_groups` makes the model groups (M consecutive ranks)
and the data groups (the D ranks that share a model index), every rank
making every group in one order, model groups first.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.schemes import DistGroup, world_sizes

BACKENDS = ("gloo", "nccl")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# bounds every collective, so that a rank that died fails the others in
# minutes instead of leaving them waiting (the slowest collective of the
# full-width trainer, its start-up broadcast, takes seconds)
TIMEOUT = datetime.timedelta(seconds=300)


def check_node_size(dp: int, node_size: int) -> None:
    """``node_size`` must divide the data-parallel degree D (the
    reference's ``split_node_axes`` check)."""
    if node_size < 1:
        raise ValueError(f"node_size must be >= 1, got {node_size}")
    if node_size > 1 and dp % node_size != 0:
        raise ValueError(
            f"node_size={node_size} does not divide the data axis "
            f"(size {dp}); pick a divisor of {dp}")


def make_level_groups(group, topology, pods: int = 1) -> None:
    """Make the groups of every level larger than one rank (the nodes, the
    cross-node columns, the pod columns) for a world of ``pods`` x
    ``topology.n`` ranks, so that GradSync's first sync finds them.  On a
    ``DistGroup`` this calls ``dist.new_group`` for every group on every
    rank in one order; on the in-process group it only checks the
    layout."""
    if topology.flat and pods == 1:
        return   # the one flat group is the world itself
    sizes = world_sizes(topology, pods)
    for axis, size in enumerate(sizes):
        if size > 1:
            group.split(sizes, axis)


def make_mesh_groups(backend: str, tp: int, device: str | None = None
                     ) -> tuple[DistGroup, DistGroup | None, torch.device]:
    """Join torchrun's world as a ``DxM`` mesh with ``tp`` = M: ``(data
    group, model group, device)``.  At M = 1 the data group is the world
    and there is no model group (:func:`make_data_group`).  Call
    ``dist.destroy_process_group()`` when done."""
    world, dev = make_data_group(backend, device)
    if tp == 1:
        return world, None, dev
    if world.n % tp:
        dist.destroy_process_group()
        raise ValueError(f"{world.n} processes do not make a mesh with "
                         f"M={tp} model ranks")
    rank, groups = world.ranks[0], {}
    for kind, members in (
            [("model", list(range(b, b + tp))) for b in range(0, world.n, tp)]
            + [("data", list(range(m, world.n, tp))) for m in range(tp)]):
        pg = dist.new_group(members)
        if rank in members:
            groups[kind] = DistGroup(pg)
    return groups["data"], groups["model"], dev


def make_data_group(backend: str, device: str | None = None
                    ) -> tuple[DistGroup, torch.device]:
    """Join the data-parallel group that ``torchrun`` set up for this
    process: ``(DistGroup, this rank's device)``.

    The device is ``cuda:(LOCAL_RANK mod device_count)`` by default, or the
    CPU when ``device="cpu"``.  Call ``dist.destroy_process_group()``
    when done."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl runs on CUDA devices only, not {dev}; use "
                         f"--dist gloo with --device cpu")
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--dist {backend} runs one process per rank under torchrun, "
            f"but {', '.join(missing)} is not set: start it with `torchrun "
            f"--standalone --nproc-per-node D -m repro_torch.launch.train "
            f"--mesh Dx1 --dist {backend} ...`, or drop --dist to hold the "
            f"D ranks in one process")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > count:
            raise ValueError(
                f"nccl places one rank on each GPU, and {local_world} ranks "
                f"share {count} GPU(s) here; use --dist gloo to run several "
                f"ranks on one GPU")
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % count)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=TIMEOUT)
    return DistGroup(), dev
