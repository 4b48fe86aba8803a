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

Tensor parallelism (``--mesh DxM`` or ``PxDxM``, M > 1) lays the world
out as the reference's mesh ``(pod, dp_inter, dp_intra, model)``, model
innermost: rank ``((p D/k + i) k + j) M + m`` with k the node size, that
is ``w M + m`` for the data index ``w = p D + d`` (pod-major).
:func:`mesh_groups` makes, on every rank and in one order, the model
groups (M consecutive ranks), the data groups (the P x D ranks that share
a model index) and then, for each model index in turn, every level group
of its data group (the nodes, the cross-node columns and the pod columns
of :func:`level_keys`), and hands each data group its level groups
already made: ``DistGroup.split`` finds them there and never calls
``new_group`` itself, which on one model index's ranks alone would
deadlock the others.
"""
from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.schemes import DistGroup, level_rows, world_sizes
from repro_torch.core.topology import build_topology

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


def production_mesh(multi_pod: bool = False, node_size: int = 1
                    ) -> tuple[int, int, int]:
    """The reference's production mesh as ``(P, D, M)``: 16 x 16 = 256
    ranks a pod, two pods with ``multi_pod`` (``make_production_mesh``);
    ``node_size`` must divide D, as ``split_node_axes`` checks it."""
    pods, dp, tp = (2, 16, 16) if multi_pod else (1, 16, 16)
    check_node_size(dp, node_size)
    return pods, dp, tp


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Join a world of ``world_size`` ranks as ``rank`` over torch's
    ``"fake"`` backend (no peer, no transfer: every collective returns at
    once, leaving its output as it is), so one process runs one rank of a
    production mesh on the meta device (``launch/dryrun.py``), the
    counterpart of the reference's forced host devices.  Yields the
    world's ``DistGroup``; the group is destroyed on exit.  Refuses to
    start where a default group exists.

    ``FakeStore`` is a torch-internal module
    (``torch.testing._internal.distributed.fake_pg``), checked on torch
    2.13.0+cpu and 2.11.0+cu128."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists "
                           "already; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield DistGroup()
    finally:
        dist.destroy_process_group()


def make_level_groups(group, topology, pods: int = 1) -> None:
    """Make the groups of every level larger than one rank (the nodes, the
    cross-node columns, the pod columns) for a world of ``pods`` x
    ``topology.n`` ranks, so that GradSync's first sync finds them.  On a
    ``DistGroup`` this calls ``dist.new_group`` for every group on every
    rank in one order; on the in-process group it only checks the
    layout."""
    for sizes, axis in level_keys(topology, pods):
        group.split(sizes, axis)


def level_keys(topology, pods: int = 1
               ) -> list[tuple[tuple[int, ...], int]]:
    """``[(sizes, axis), ...]``: the levels larger than one rank of a world
    of ``pods`` x ``topology.n`` ranks, as GradSync splits it
    (``world_sizes``), in the order every rank makes their groups; none
    for the flat world without pods (the one group is the world)."""
    if topology.flat and pods == 1:
        return []
    sizes = world_sizes(topology, pods)
    return [(sizes, axis) for axis, size in enumerate(sizes) if size > 1]


def mesh_groups(world: DistGroup, tp: int, pods: int = 1,
                node_size: int = 1) -> tuple[DistGroup, DistGroup]:
    """Lay the joined ``world`` out as a ``PxDxM`` mesh with ``tp`` = M > 1
    (D = world / (P M), nodes of ``node_size`` data ranks): ``(data group,
    model group)`` of this rank, its data group holding its level groups.
    Every rank makes every group of the world in one fixed order (a
    collective call: every rank must call it alike); calling it again
    lays the same world out anew through new groups."""
    n, rank = world.n, world.ranks[0]
    if n % (tp * pods):
        raise ValueError(f"{n} processes do not make a mesh of {pods} "
                         f"pod(s) with M={tp} model ranks")
    ndata = n // tp
    check_node_size(ndata // pods, node_size)
    groups = {}
    for kind, members in (
            [("model", list(range(b, b + tp))) for b in range(0, n, tp)]
            + [("data", list(range(m, n, tp))) for m in range(tp)]):
        pg = dist.new_group(members)
        if rank in members:
            groups[kind] = DistGroup(pg)
    data = groups["data"]
    keys = level_keys(build_topology(ndata // pods, node_size), pods)
    for m in range(tp):
        for sizes, axis in keys:
            mine = None
            for rows in level_rows(sizes, axis):
                pg = dist.new_group([w * tp + m for w in rows])
                if rank % tp == m and rank // tp in rows:
                    mine = DistGroup(pg)
            if mine is not None:
                data.adopt_level(sizes, axis, mine)
    return data, groups["model"]


def make_mesh_groups(backend: str, tp: int, pods: int = 1,
                     node_size: int = 1, device: str | None = None
                     ) -> tuple[DistGroup, DistGroup | None, torch.device]:
    """Join torchrun's world as a ``PxDxM`` mesh with ``tp`` = M: ``(data
    group, model group, device)`` (:func:`mesh_groups`).  At M = 1 the
    data group is the world and there is no model group
    (:func:`make_data_group`; :func:`make_level_groups` makes its level
    groups).  Call ``dist.destroy_process_group()`` when done."""
    world, dev = make_data_group(backend, device)
    if tp == 1:
        return world, None, dev
    try:
        return (*mesh_groups(world, tp, pods, node_size), dev)
    except ValueError:
        dist.destroy_process_group()
        raise


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
