"""Gradient-synchronization API (port of ``repro.core.zen``).

``GradSync`` maps the per-worker gradients of a model (one ``[local, ...]``
stack per leaf: all ``n`` workers on the in-process ``SimGroup``, this
process's one rank on a ``DistGroup``) to their mean over the data-parallel
group.  Leaves named in ``sparse_paths`` (the row-sparse input embedding
``embed/table``) go through the configured sparse scheme; every other leaf
is a psum.  The leaves are partitioned into buckets (``core/buckets.py``:
dense leaves fused up to ``bucket_bytes``, one bucket per leaf without it)
and synced in the reference's double-buffered pipeline
(``train/schedule.py``): on CUDA every bucket's encode runs on a side
stream GradSync keeps, beside the previous bucket's commit.  The port
covers the flat topology with ``scheme`` in {``zen``, ``dense``} and no
compression; any other setting raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""
from __future__ import annotations

import collections.abc
import dataclasses
from typing import Sequence

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import schemes
from repro_torch.core.hashing import check_backend
from repro_torch.core.schemes import (DistGroup, SimGroup, SyncStats,
                                      make_zen_layout)
from repro_torch.train import schedule


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """How gradients are synchronized across the data-parallel group; the
    reference's fields, of which the port runs a subset (see GradSync)."""

    scheme: str = "zen"           # zen | dense
    density_budget: float = 0.25  # capacity sizing for sparse buffers
    k: int = 3                    # Alg. 1 rehash rounds
    r1_factor: float = 2.0        # r1 = r1_factor * nnz_budget / n
    r2_ratio: float = 0.1         # r2 = r2_ratio * r1
    use_hash_bitmap: bool = True  # Alg. 2 on Pull (Fig. 18 ablation knob)
    seed: int = 0                 # hash seeds: schemes.default_seeds(seed)
    # Route of Zen's encode / commit / pull stages: "cuda" runs the CUDA
    # kernels (their plain versions for CPU tensors), "torch" the plain
    # versions everywhere.  "cuda" is the counterpart of the reference's
    # "pallas" route; "torch" of its "xla" route.
    backend: str = "cuda"
    # the fused encode / commit megakernels, or the pre-fusion chain of
    # smaller kernels; the same bits either way
    fused_encode: bool = True
    fused_commit: bool = True
    calib_file: str | None = None
    bucket_bytes: int | None = None
    alpha_beta: str | None = None
    compress: str = "none"


def _unsupported(cfg: SyncConfig) -> str | None:
    """Why the port cannot run ``cfg`` yet, or None."""
    if cfg.scheme not in ("zen", "dense"):
        return (f"scheme {cfg.scheme!r}: the port runs 'zen' and 'dense'; "
                f"the other schemes and 'auto' are ROADMAP queue 1, item 6")
    if cfg.compress != "none":
        return "EF compression: ROADMAP queue 1, item 5 (core/sparsify.py)"
    if cfg.calib_file is not None:
        return "measured-cost calibration: ROADMAP queue 1, item 7"
    if cfg.alpha_beta is not None:
        return "two-level topologies: ROADMAP queue 1, item 9"
    return None


class GradSync:
    """Synchronize stacked per-worker gradients over a flat group.

    Args:
      cfg: SyncConfig.
      sparse_paths: path substrings marking row-sparse 2-D leaves.
      leaves: ``[(name, per-worker shape, dtype), ...]`` in gradient
          order; the Zen layouts and the bucket plan are built from them
          offline.
      n_data: size of the data-parallel group.
      group: the collectives' group: by default ``SimGroup(n_data)`` (all
          workers in this process); a ``DistGroup`` of size ``n_data``
          runs this process's rank over ``torch.distributed``.
    """

    def __init__(self, cfg: SyncConfig, sparse_paths: Sequence[str],
                 leaves: Sequence[tuple[str, tuple, torch.dtype]],
                 n_data: int,
                 group: SimGroup | DistGroup | None = None):
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(f"GradSync: {why}")
        check_backend(cfg.backend)
        if group is not None and group.n != n_data:
            raise ValueError(f"GradSync: n_data {n_data} != the group's "
                             f"size {group.n}")
        self.cfg = cfg
        self.n_data = n_data
        self.group = group or SimGroup(n_data)
        self.sparse_paths = tuple(sparse_paths)
        # the encodes' side stream, one per CUDA device (train/schedule.py)
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

        def resolve_scheme(name: str, shape: tuple) -> str:
            if len(shape) > 2:
                raise ValueError(f"sparse leaf {name} must be 2-D, got {shape}")
            return cfg.scheme

        self.names = [name for name, _, _ in leaves]
        self.plan = bk.make_bucket_plan(leaves, self._is_sparse,
                                        cfg.bucket_bytes, resolve_scheme)
        self._layouts = {
            b.key: make_zen_layout(
                b.slots[0].shape[0], n_data,
                density_budget=cfg.density_budget, key=cfg.seed, k=cfg.k,
                r1_factor=cfg.r1_factor, r2_ratio=cfg.r2_ratio)
            for b in self.plan.buckets
            if b.kind == bk.SPARSE and b.scheme == "zen" and n_data > 1}

    def _is_sparse(self, name: str) -> bool:
        return any(s in name for s in self.sparse_paths)

    def describe(self) -> list[str]:
        """One line per bucket, the reference's: kind, bytes, plan, key."""
        lines = [f"topology: data[{self.n_data}] α=0µs β=1µs/w"]
        for b in self.plan.buckets:
            lines.append(f"bucket {b.bid:3d} {b.kind:11s} {b.nbytes:>10d}B "
                         f"plan=[{b.scheme}@data[{self.n_data}]]  {b.key}")
        return lines

    def _encode_bucket(self, bucket: bk.Bucket, payload: torch.Tensor):
        """Local, collective-free stage: Zen buckets encode to (indices,
        values); everything else passes through."""
        if bucket.key in self._layouts:
            enc = schemes.zen_encode(payload, layout=self._layouts[bucket.key],
                                     backend=self.cfg.backend,
                                     fused=self.cfg.fused_encode)
            return (payload, enc)
        return (payload,)

    def _commit_bucket(self, bucket: bk.Bucket,
                       enc) -> tuple[torch.Tensor, SyncStats]:
        """Collectives + decode-apply, then the mean (every scheme sums)."""
        g, n = enc[0], self.group.n
        if n <= 1:
            zero = torch.zeros(g.shape[0], dtype=torch.float32,
                               device=g.device)
            return g, SyncStats(sent_words=zero,
                                overflow=zero.to(torch.int32))
        if len(enc) > 1:
            out, st = schemes.zen_commit(
                enc[1], g, group=self.group,
                layout=self._layouts[bucket.key],
                use_hash_bitmap=self.cfg.use_hash_bitmap,
                backend=self.cfg.backend, fused=self.cfg.fused_commit)
        else:
            out, st = schemes.dense_sync(g, group=self.group)
        if out.stride(0) == 0:   # SimGroup: one psum seen by every worker
            return (out[0] / n).expand_as(out), st
        return out / n, st

    def _side_stream(self, dev: torch.device) -> torch.cuda.Stream | None:
        """The encodes' side stream on a CUDA ``dev`` (made on first use),
        None on the CPU."""
        if dev.type != "cuda":
            return None
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _payloads(self, grads: dict[str, torch.Tensor]):
        """(leaf stacks in leaf order, bucket payloads): each payload is
        assembled when the schedule reads it, in its encode's slot."""
        flat = [grads[nm] for nm in self.names]
        return flat, _Payloads(self.plan.buckets, flat)

    def __call__(self, grads: dict[str, torch.Tensor]):
        """``{leaf name: [local, ...] per-worker grads}`` -> (the same dict
        of [local, ...] synced means, metric dict of per-worker vectors)."""
        flat, payloads = self._payloads(grads)
        outs, per_bucket = schedule.run_schedule(
            self.plan.buckets, payloads, self._encode_bucket,
            self._commit_bucket, stream=self._side_stream(flat[0].device))
        return self._unbucket(flat, outs, per_bucket)

    def _unbucket(self, flat: list, outs: list, per_bucket: list):
        """The synced leaf dict and metrics from the buckets' outputs."""
        synced = list(flat)
        for b, out in zip(self.plan.buckets, outs):
            bk.scatter_bucket(b, out, synced)
        return dict(zip(self.names, synced)), bk.reduce_stats(self.plan,
                                                              per_bucket)


class _Payloads(collections.abc.Sequence):
    """The buckets' payloads as a sequence that gathers bucket ``i``'s
    leaves when it is read (``core/buckets.gather_bucket``)."""

    def __init__(self, buckets: Sequence[bk.Bucket], flat: list):
        self.buckets, self.flat = buckets, flat

    def __len__(self) -> int:
        return len(self.buckets)

    def __getitem__(self, i: int) -> torch.Tensor:
        return bk.gather_bucket(self.buckets[i], self.flat)
