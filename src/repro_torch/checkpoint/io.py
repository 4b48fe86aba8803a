"""Checkpointing (port of ``repro.checkpoint.io``): a nested dict of
tensors and ints saved as ``arrays.npz`` plus ``manifest.json``.

Each leaf is keyed by its ``/``-joined path; the manifest lists every
leaf's path (as a list of keys, so keys that hold ``/`` themselves, like
the model's leaf names, round-trip), dtype and shape.  bfloat16 tensors are
stored as a uint16 view, as the reference stores them (npz has no bf16);
an int leaf is stored as a 0-d int64 array and comes back an int.  No
pickle is written or read.  Tensors are copied to the host to be written:
one process writes (rank 0 on a process group).

Under tensor parallelism the checkpoint is host-gathered, as DESIGN.md §5
has it: :func:`gather_params` gathers each model-sharded leaf over the
model group into its global shape (every process calls it; rank 0
writes), :func:`load_params` slices a global leaf back to this rank's
shard, and :func:`gather_state` / :func:`scatter_state` stack every
process's optimizer state over the world's ranks and hand each process
its own row back, so that a restore on the same mesh continues bit for
bit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.schemes import DistGroup

_BF16 = "bfloat16"
_INT = "int"


def _leaves(tree, prefix=()):
    """(path tuple, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint keys must be str, got {k!r}")
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (torch.Tensor, int)) and not isinstance(tree, bool):
        yield prefix, tree
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)} must be a "
                        f"tensor or an int, got {type(tree).__name__}")


def save(path, tree: dict) -> None:
    """Write ``tree`` (nested dicts of tensors and ints) under ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays, manifest = {}, []
    for keys, leaf in _leaves(tree):
        name = "/".join(keys)
        if name in arrays:
            raise ValueError(f"checkpoint leaf name {name!r} is not unique")
        if isinstance(leaf, int):
            a, kind = np.asarray(leaf, dtype=np.int64), _INT
        else:
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                a, kind = t.view(torch.int16).numpy().view(np.uint16), _BF16
            else:
                a, kind = t.numpy(), str(t.dtype).replace("torch.", "")
        arrays[name] = a
        manifest.append({"name": name, "path": list(keys), "dtype": kind,
                         "shape": list(a.shape)})
    np.savez(path / "arrays.npz", **arrays)
    (path / "manifest.json").write_text(json.dumps({"leaves": manifest}))


def restore(path, device=None) -> dict:
    """Read a checkpoint written by :func:`save`: tensors on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``), ints as ints."""
    path = Path(path)
    dev = resolve_device(device)
    manifest = json.loads((path / "manifest.json").read_text())["leaves"]
    out: dict = {}
    with np.load(path / "arrays.npz", allow_pickle=False) as data:
        for leaf in manifest:
            a = data[leaf["name"]]
            if list(a.shape) != leaf["shape"]:
                raise ValueError(f"checkpoint leaf {leaf['name']}: shape "
                                 f"{a.shape} != manifest {leaf['shape']}")
            if leaf["dtype"] == _INT:
                val = int(a)
            elif leaf["dtype"] == _BF16:
                val = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).to(dev)
            else:
                val = torch.from_numpy(a).to(dev)
            node = out
            for k in leaf["path"][:-1]:
                node = node.setdefault(k, {})
            node[leaf["path"][-1]] = val
    return out


@torch.no_grad()
def gather_params(model) -> dict:
    """{leaf name: the GLOBAL leaf}: each model-sharded leaf all-gathered
    over the model group along its sharded dim (a collective: every
    process of the group calls it), the others as they are."""
    ctx, out = model.ctx, {}
    dims = model.shard_dims() if ctx.tp > 1 else {}
    for name, p in model.named_leaves():
        dim = dims.get(name)
        out[name] = (p if dim is None else
                     ctx.all_gather_tp(p.movedim(dim, 0)).movedim(0, dim))
    return out


@torch.no_grad()
def load_params(model, params: dict) -> None:
    """Copy GLOBAL leaves (:func:`gather_params`' tree) into ``model``,
    each sliced to this rank's shard."""
    dims = model.shard_dims() if model.ctx.tp > 1 else {}
    for name, p in model.named_leaves():
        p.copy_(model.ctx.shard(params[name], dims.get(name)))


def gather_state(state, world: DistGroup):
    """An optimizer state (``Program.opt_state()``) with every tensor
    stacked over the world's processes in rank order ([world, ...]); ints
    as they are (a collective)."""
    if isinstance(state, dict):
        return {k: gather_state(v, world) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return world.all_gather(state[None])
    return state


@torch.no_grad()
def scatter_state(state: dict, tree: dict, world: DistGroup) -> None:
    """Load :func:`gather_state`'s ``tree`` into ``state`` IN PLACE: this
    process's row of every tensor; the ints as they are."""
    for k, v in tree.items():
        if isinstance(v, dict):
            scatter_state(state[k], v, world)
        elif isinstance(v, torch.Tensor):
            state[k].copy_(v[world.ranks[0]])
        else:
            state[k] = v
