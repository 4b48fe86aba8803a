"""Checkpointing (port of ``repro.checkpoint.io``): a nested dict of
tensors and ints saved as ``arrays.npz`` plus ``manifest.json``.

Each leaf is keyed by its ``/``-joined path; the manifest lists every
leaf's path (as a list of keys, so keys that hold ``/`` themselves, like
the model's leaf names, round-trip), dtype and shape.  bfloat16 tensors are
stored as a uint16 view, as the reference stores them (npz has no bf16);
an int leaf is stored as a 0-d int64 array and comes back an int.  No
pickle is written or read.  Tensors are copied to the host to be written:
one process writes (rank 0 on a process group).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device

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
