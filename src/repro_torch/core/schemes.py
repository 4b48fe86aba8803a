"""Gradient synchronization schemes over a group of workers.

Port of ``repro.core.schemes``: dense (ring allreduce), the paper's
baselines (agsparse, sparcml, sparse_ps, omnireduce, balanced) and Zen,
with the registry-driven ``stage_sync`` and the capacity provisioning
(``stage_args_for``, ``plan_stage_args``).  The reference
writes each scheme as an SPMD function of one worker's gradient with named
``jax.lax`` collectives and runs it under ``vmap`` (simulated) or
``shard_map`` (one program per device).  Here a scheme takes the gradients
of the workers this process holds, stacked on a leading dimension
``[local, M(, d)]``, and runs the collectives through a group that says
which global ranks those are (``group.ranks``):

* :class:`SimGroup`, the in-process simulated group (the ``vmap``
  counterpart): the process holds all ``n`` workers; ``all_to_all`` is a
  transpose of the (source, destination) dimensions, ``all_gather`` hands
  every worker the same stacked tensor, ``psum`` sums in worker order
  0..n-1, ``ppermute`` reorders the workers;
* :class:`DistGroup`, one rank of a ``torch.distributed`` process group
  (the ``shard_map`` counterpart): the process holds one worker
  (``local = 1``) and each collective is the group's own.

Worker ``w`` is also server ``w`` (it owns the hash partition ``I_w``,
or the index range ``w`` of the range-partitioned schemes).  Outputs keep
the leading local dimension (one synced copy per worker) and
:class:`SyncStats` fields are per-worker vectors, like the reference's
``simulate``.  Where every local worker decodes the same gathered stack
(agsparse's reduce and the pull decodes of sparse_ps, omnireduce and
balanced), the decode runs once and is expanded over the local dimension:
the same bits as one decode per worker.  The outputs are the same bits on
both groups: pushes and gathers deliver the sources in rank order, so
every server sums its stream in the same order.

A two-level plan (``hier_sync``, ``simulate_hier``) runs each stage over
the groups of its topology level: ``group.split(sizes, axis)`` hands back
the rows and the subgroup of each (a ``SimGroup`` splits its stack, a
``DistGroup`` this rank's ``dist.new_group``), and ``level_sync`` runs the
stage once for each distinct input, so a psum's shared node sum is not
synced again for every column of the next level.

``backend`` selects the route of the kernel stages: ``"cuda"`` goes
through ``kernels/ops.py`` (the CUDA kernels for CUDA tensors), ``"torch"``
calls the plain versions in ``kernels/ref.py`` directly.  Zen's ``fused``
(encode) and ``fused_commit`` (push + pull) pick the fused megakernels or
the pre-fusion chain of smaller kernels.  Every other scheme's server
aggregation is ``_coo_reduce``: the stream-order scatter-add kernel on
``"cuda"`` (never ``index_add_``, whose CUDA atomics add duplicate
targets in no fixed order).  Every combination gives the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import formats
from repro_torch.core import registry as sreg
from repro_torch.core.hashing import (EMPTY, check_backend, compact_rows,
                                      extract_partitions, hash_mod,
                                      hierarchical_hash)
from repro_torch.core.registry import BALANCED_BINS, StageArgs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class SyncStats(NamedTuple):
    """Per-worker accounting: f32 wire words sent and int32 overflows.

    ``by_level`` tags the wire words by topology level for two-level plans
    (fastest level first: ``(intra_words, inter_words)``); flat schemes
    leave it empty, meaning "all words at level 0"."""

    sent_words: torch.Tensor  # f32 [n]
    overflow: torch.Tensor    # int32 [n]
    by_level: tuple = ()      # per-level f32 [n] wire words (hier plans)


def zero_stats(local: int, device) -> SyncStats:
    """No words and no overflow for ``local`` workers (a skipped level)."""
    zero = torch.zeros(local, dtype=torch.float32, device=device)
    return SyncStats(sent_words=zero, overflow=zero.to(torch.int32))


def level_rows(sizes: Sequence[int], axis: int) -> list[list[int]]:
    """The groups of one level of a world laid out as the mixed-radix
    ``sizes`` (outermost first, e.g. ``(pods, n_inter, n_intra)``): each
    group is the ranks that differ only in digit ``axis``, in that digit's
    order.  The intra groups are consecutive ranks ``[k*ns, ..., k*ns +
    ns - 1]``, the inter groups ``[j, j + ns, ...]``, as the reference's
    ``simulate_hier`` and ``launch/mesh.py`` lay out a node's workers."""
    ids = np.arange(math.prod(sizes)).reshape(tuple(sizes))
    ids = np.moveaxis(ids, axis, -1).reshape(-1, sizes[axis])
    return [[int(r) for r in row] for row in ids]


class SimGroup:
    """The in-process simulated group of ``n`` workers (leading dim)."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = range(n)

    def split(self, sizes: Sequence[int], axis: int
              ) -> list[tuple[list[int], "SimGroup"]]:
        """The groups of level ``axis`` of the world laid out as ``sizes``
        (:func:`level_rows`): ``[(rows of the stack, SimGroup), ...]``."""
        if math.prod(sizes) != self.n:
            raise ValueError(f"level sizes {tuple(sizes)} do not cover the "
                             f"group's {self.n} workers")
        return [(rows, SimGroup(sizes[axis]))
                for rows in level_rows(sizes, axis)]

    def rank_ids(self, device) -> torch.Tensor:
        """int64 [local] global rank of each local worker (the counterpart
        of ``lax.axis_index``), built on ``device``."""
        return torch.arange(self.n, device=device)

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """[n, ...] -> [n, ...]: worker ``dst`` receives worker ``src``'s
        block for each ``(src, dst)`` pair; a worker that receives nothing
        gets zeros (``lax.ppermute``)."""
        out = torch.zeros_like(x)
        for src, dst in pairs:
            out[dst] = x[src]
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[n_src, n_dst, ...] -> [n_dst, n_src, ...]: destination ``j``
        receives every source's block ``j``."""
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n, ...] per-worker blocks -> the [n, ...] stack every worker
        sees (one shared tensor: the copies would be identical)."""
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """[n, ...] -> [n, ...]: every worker gets the sum, taken in worker
        order 0..n-1 in the values' dtype."""
        acc = x[0].clone()
        for w in range(1, x.shape[0]):
            acc += x[w]
        return acc.expand_as(x)

    def mean(self, vals: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``{name: [n] per-worker values}`` -> f32 means over the group."""
        return {k: v.float().mean() for k, v in vals.items()}

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Every worker already shares the one copy: nothing to send."""


# all_gather into one tensor; older torch names it all_gather_into_tensor
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


class DistGroup:
    """This process's rank of a ``torch.distributed`` process group (the
    default group, which ``launch/mesh.py`` joins, or ``pg``): the leading
    dimension of every stack is 1 (``local``), and the group's collectives
    run on the tensors' own device (gloo stages CUDA tensors through host
    memory itself; the kernels stay on the card).  ``ranks`` holds this
    process's rank inside the group, the counterpart of ``lax.axis_index``
    over the group's axis."""

    def __init__(self, pg=None):
        self.pg = pg
        self.n = dist.get_world_size(pg)
        self.ranks = (dist.get_rank(pg),)
        self._levels: dict = {}

    def split(self, sizes: Sequence[int], axis: int
              ) -> list[tuple[list[int], "DistGroup"]]:
        """This rank's group of level ``axis`` of the world laid out as
        ``sizes`` (:func:`level_rows` over this group's ranks):
        ``[([0], DistGroup)]``.  On the world group the first call makes
        every group of the level with ``dist.new_group``, on every rank in
        one order (a collective call: every rank must split alike); a
        sub-group (a data group under a model axis) finds the groups
        :meth:`adopt_level` gave it and raises for any other."""
        key = (tuple(sizes), axis)
        if key not in self._levels:
            if self.pg is not None:
                raise RuntimeError(
                    f"level {key} of a data group was not made with the "
                    f"mesh: under a model axis every rank makes every "
                    f"level group in one order (launch/mesh.mesh_groups); "
                    f"making them here on one data group's ranks alone "
                    f"would deadlock the others")
            if math.prod(sizes) != self.n:
                raise ValueError(f"level sizes {tuple(sizes)} do not cover "
                                 f"the group's {self.n} ranks")
            mine = None
            for rows in level_rows(sizes, axis):
                pg = dist.new_group([self._global(r) for r in rows])
                if self.ranks[0] in rows:
                    mine = DistGroup(pg)
            self._levels[key] = mine
        return [([0], self._levels[key])]

    def adopt_level(self, sizes: Sequence[int], axis: int,
                    group: "DistGroup") -> None:
        """Hand this group its group of level ``axis`` of ``sizes``, made
        by the caller in the world's order (``launch/mesh.mesh_groups``),
        for :meth:`split` to find."""
        if math.prod(sizes) != self.n:
            raise ValueError(f"level sizes {tuple(sizes)} do not cover the "
                             f"group's {self.n} ranks")
        self._levels[tuple(sizes), axis] = group

    def rank_ids(self, device) -> torch.Tensor:
        """int64 [1]: this process's rank, built on ``device`` (nothing
        crosses from the host)."""
        r = self.ranks[0]
        return torch.arange(r, r + 1, device=device)

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """[1, ...] -> [1, ...]: this rank sends its block to ``dst`` and
        receives ``src``'s for the ``(src, dst)`` pairs naming it (zeros if
        none), as one ``all_to_all_single`` with split sizes (alltoallv:
        one peer's share non-empty each way)."""
        src = self._one(x)[0].reshape(-1)
        r, k = self.ranks[0], src.numel()
        send = dict(pairs).get(r)
        recv = {d: s for s, d in pairs}.get(r)
        out = torch.zeros_like(src)
        dist.all_to_all_single(
            out, src, [k if j == recv else 0 for j in range(self.n)],
            [k if j == send else 0 for j in range(self.n)], group=self.pg)
        return out.view(x.shape)

    @staticmethod
    def _one(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != 1:
            raise ValueError(f"DistGroup holds one rank: need a [1, ...] "
                             f"stack, got {tuple(x.shape)}")
        return x.contiguous()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """[1, n_dst, ...] -> [1, n_src, ...]: block ``j`` goes to rank
        ``j``; the blocks arrive in source-rank order."""
        src = self._one(x)[0]
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.pg)
        return out[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] -> [n, ...], rank order."""
        x = self._one(x)
        out = x.new_empty((self.n, *x.shape[1:]))
        _all_gather_single(out, x, group=self.pg)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] -> [1, ...]: the group's sum (``all_reduce``, DDP's
        idiom).  The order of the adds is the backend's: bitwise the
        simulated group's at two ranks, within the summation bound
        ``(n - 1) u sum|x|`` beyond."""
        out = self._one(x).clone()
        dist.all_reduce(out, group=self.pg)
        return out

    def mean(self, vals: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``{name: [1] values}`` -> f32 means over the group: one
        ``all_reduce`` of the sums, so every rank returns the same."""
        sums = torch.stack([v.float().sum() for v in vals.values()])
        dist.all_reduce(sums, group=self.pg)
        return dict(zip(vals, (sums / self.n).unbind()))

    def _global(self, r: int) -> int:
        """The default group's rank of this group's rank ``r``."""
        return r if self.pg is None else dist.get_global_rank(self.pg, r)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with rank 0's, one flat buffer per dtype
        (DDP's start-up broadcast)."""
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=self._global(0), group=self.pg)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.detach().copy_(part.view_as(t))


def _nnz(idx: torch.Tensor) -> torch.Tensor:
    """f32 count of live entries along the last dim."""
    return (idx != EMPTY).to(torch.float32).sum(-1)


def _vwidth(dense: torch.Tensor) -> int:
    """Words per value of a per-worker tensor: 1 element-sparse, d rows."""
    return 1 if dense.ndim == 1 else dense.shape[-1]


def _worker_mask(dense: torch.Tensor) -> torch.Tensor:
    """[n, M] non-zero mask of stacked worker gradients [n, M, ...]: an
    element, or a row (block) with any non-zero."""
    if dense.ndim == 2:
        return dense != 0
    return (dense != 0).reshape(*dense.shape[:2], -1).any(dim=-1)


def _gather_rows(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dense[idx] with EMPTY -> 0; idx may have any shape."""
    dead = idx == EMPTY
    flat = torch.where(dead, 0, idx).reshape(-1).to(torch.int64)
    vals = dense.index_select(0, flat).reshape(*idx.shape, *dense.shape[1:])
    dead = dead.view(*idx.shape, *([1] * (dense.ndim - 1)))
    return torch.where(dead, torch.zeros((), dtype=vals.dtype,
                                         device=vals.device), vals)


def _scatter_unique(out: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Collision-free scatter for provably disjoint live targets (Thm. 2):
    servers own disjoint index ranges and positions within a range are
    unique.  EMPTY targets go to a dump row that is cut off."""
    M = out.shape[0]
    tgt = torch.where(idx == EMPTY, M, idx).to(torch.int64)
    full = torch.cat([out, out.new_zeros((1, *out.shape[1:]))])
    full.index_copy_(0, tgt, vals)
    return full[:M]


def _coo_reduce(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                *, backend: str = "torch") -> torch.Tensor:
    """The batched segment-reduce of the server aggregation: ``out [M(, d)]
    += vals`` at row ``idx``, EMPTY / out-of-range dropped, ``out`` updated
    in place and returned (``kernels.ops.batched_coo_reduce_op``)."""
    return kops.batched_coo_reduce_op(out, idx, vals, backend=backend)


# ---------------------------------------------------------------------------
# Dense baseline
# ---------------------------------------------------------------------------

def dense_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup):
    """Ring allreduce: every worker gets the sum of [local, ...]
    gradients."""
    n, local = group.n, dense.shape[0]
    out = group.psum(dense)
    # made on the device: a host tensor's copy would sync the host
    words = torch.full((), 2 * (n - 1) / n, dtype=torch.float32,
                       device=dense.device) * dense[0].numel()
    stats = SyncStats(sent_words=words.expand(local),
                      overflow=torch.zeros(local, dtype=torch.int32,
                                           device=dense.device))
    return out, stats


# ---------------------------------------------------------------------------
# The paper's baselines (Table 2) and the balanced split-and-exchange
# ---------------------------------------------------------------------------

def _encode_rows(dense: torch.Tensor, capacity: int):
    """COO of each row of a stack ``[r, L(, d)]`` (``formats.coo_encode``
    row by row): (indices int32 [r, capacity], values [r, capacity(, d)],
    overflow int32 [r])."""
    idx, ov = compact_rows(_worker_mask(dense), capacity)
    return idx, _gather_stack(dense, idx), ov


def _gather_stack(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dense[w][idx[w]]`` for every row ``w`` of a stack ``[r, L, ...]``
    and ``idx [r, ...]`` (EMPTY -> 0), in one gather."""
    r, L = dense.shape[:2]
    base = (torch.arange(r, device=idx.device) * L).view(
        r, *([1] * (idx.ndim - 1)))
    glob = torch.where(idx == EMPTY, EMPTY, idx + base)
    return _gather_rows(dense.reshape(r * L, *dense.shape[2:]), glob)


def _expand(out: torch.Tensor, local: int) -> torch.Tensor:
    """One decode of the gathered stack, seen by every local worker."""
    return out[None].expand(local, *out.shape)


def agsparse_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup,
                  capacity: int, backend: str = "torch"):
    """AllGather of fixed-capacity COO; every worker aggregates
    everything."""
    n, local = group.n, dense.shape[0]
    idx, vals, ov = _encode_rows(dense, capacity)
    all_idx = group.all_gather(idx)                    # [n, C]
    all_val = group.all_gather(vals)                   # [n, C(, d)]
    out = _coo_reduce(torch.zeros_like(dense[0]), all_idx, all_val,
                      backend=backend)
    sent = (n - 1) * _nnz(idx) * (1 + _vwidth(dense[0]))
    return _expand(out, local), SyncStats(sent_words=sent, overflow=ov)


def sparcml_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup, n: int,
                 capacity: int, backend: str = "torch"):
    """Recursive doubling with incremental aggregation and COO exchange
    (SSAR_Recursive_double).

    Stage s pairs rank with rank XOR 2^s; the exchanged set doubles in the
    worst case each stage, so stage capacity is ``min(capacity * 2^s * 2,
    M)``.  Each received COO is added into the running sum in place."""
    if n <= 0 or n & (n - 1) != 0:
        raise ValueError(
            f"sparcml_sync: recursive doubling needs a power-of-two worker "
            f"count, got n={n}. Pad the data-parallel axis to the next power "
            f"of two, or pick scheme='zen', which accepts any n.")
    _check_n(group, n, "sparcml_sync")
    local, M = dense.shape[:2]
    acc = dense.clone()
    sent = torch.zeros(local, dtype=torch.float32, device=dense.device)
    overflow = torch.zeros(local, dtype=torch.int32, device=dense.device)
    vw = _vwidth(dense[0])
    for s in range(int(math.log2(n))):
        cap_s = min(capacity * (2 ** s) * 2, M)
        idx, vals, ov = _encode_rows(acc, cap_s)
        perm = [(i, i ^ (1 << s)) for i in range(n)]
        got_idx = group.ppermute(idx, perm)
        got_val = group.ppermute(vals, perm)
        for w in range(local):
            _coo_reduce(acc[w], got_idx[w], got_val[w], backend=backend)
        sent = sent + _nnz(idx) * (1 + vw)
        overflow = overflow + ov
    return acc, SyncStats(sent_words=sent, overflow=overflow)


def _check_n(group, n: int, what: str) -> None:
    if n != group.n:
        raise ValueError(f"{what}: n={n} but the group has {group.n} ranks")


def _own(counts: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """``counts[w, rank_w]``: each local worker's count for its own
    partition (the part it keeps, off the wire)."""
    return counts[torch.arange(counts.shape[0], device=counts.device), ranks]


def sparse_ps_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup,
                   n: int, cap_push: int, cap_pull: int,
                   backend: str = "torch"):
    """P2P + one-shot + parallelism with *even contiguous* partitions.

    Each worker doubles as server ``rank``.  Because the partition is
    positional, C3 skew concentrates non-zeros in few partitions: correct
    provisioning needs ``cap_push ≈ skew × nnz / n``, the imbalance
    cost."""
    local, M = dense.shape[:2]
    if M % n != 0:
        raise ValueError(
            f"sparse_ps_sync: even-range partitioning needs the tensor length "
            f"to divide by the worker count, got M={M}, n={n} "
            f"(M % n = {M % n}). Pad the tensor to "
            f"{(M + n - 1) // n * n} rows or use scheme='zen', whose hash "
            f"partitioning has no divisibility requirement.")
    _check_n(group, n, "sparse_ps_sync")
    shard, vshape = M // n, tuple(dense.shape[2:])
    vw = _vwidth(dense[0])
    dev = dense.device
    # --- Push: split into n contiguous ranges, COO-encode each ---------------
    parts = dense.reshape(local * n, shard, *vshape)
    idx, vals, ov = _encode_rows(parts, cap_push)   # range-local indices
    idx = idx.view(local, n, cap_push)
    got_idx = group.all_to_all(idx)
    got_val = group.all_to_all(vals.view(local, n, cap_push, *vshape))
    # --- Server aggregation ---------------------------------------------------
    buf = torch.zeros((local, shard, *vshape), dtype=dense.dtype, device=dev)
    for s in range(local):
        _coo_reduce(buf[s], got_idx[s], got_val[s], backend=backend)
    # --- Pull: COO of the aggregated shard, all_gather -------------------------
    pidx, pval, ov_p = _encode_rows(buf, cap_pull)
    all_idx = group.all_gather(pidx)                 # [n, cap_pull]
    all_val = group.all_gather(pval)
    rank_off = (torch.arange(n, dtype=torch.int32, device=dev) * shard)[:, None]
    glob = torch.where(all_idx == EMPTY, EMPTY, all_idx + rank_off)
    out = _coo_reduce(torch.zeros_like(dense[0]), glob, all_val,
                      backend=backend)
    nnz = _nnz(idx)                                   # [local, n]
    sent = (nnz.sum(-1) - _own(nnz, group.rank_ids(dev))
            + (n - 1) * _nnz(pidx)) * (1 + vw)
    overflow = ov.view(local, n).sum(-1, dtype=torch.int32) + ov_p
    return _expand(out, local), SyncStats(sent_words=sent, overflow=overflow)


def omnireduce_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup,
                    n: int, block: int, cap_push: int, cap_pull: int,
                    backend: str = "torch"):
    """As Sparse PS but transmitting non-zero *blocks* of ``block`` rows (no
    per-element index).  The servers' block adds are one coo reduce over
    rows of width ``block · d``."""
    local, M = dense.shape[:2]
    if M % n != 0 or (M // n) % block != 0:
        raise ValueError(
            f"omnireduce_sync: needs M divisible by n*block so every worker's "
            f"contiguous range is a whole number of blocks, got M={M}, n={n}, "
            f"block={block}. Pad the tensor to "
            f"{(M + n * block - 1) // (n * block) * (n * block)} rows, shrink "
            f"`block`, or use scheme='zen' (no divisibility requirement).")
    _check_n(group, n, "omnireduce_sync")
    shard, vshape = M // n, tuple(dense.shape[2:])
    nb, bshape = shard // block, (block, *tuple(dense.shape[2:]))
    dev = dense.device
    # --- Push: each range's non-zero blocks --------------------------------------
    blocked = dense.reshape(local * n, nb, *bshape)
    ids, vals, ov = _encode_rows(blocked, cap_push)
    got_ids = group.all_to_all(ids.view(local, n, cap_push))
    got_val = group.all_to_all(vals.view(local, n, cap_push, *bshape))
    # --- Server aggregation: block adds -----------------------------------------
    buf = torch.zeros((local, nb, *bshape), dtype=dense.dtype, device=dev)
    for s in range(local):
        _coo_reduce(buf[s].view(nb, -1), got_ids[s], got_val[s],
                    backend=backend)
    # --- Pull: the aggregated range's non-zero blocks, all_gather --------------
    pids, pval, ov_p = _encode_rows(buf, cap_pull)
    all_ids = group.all_gather(pids)
    all_val = group.all_gather(pval)
    rank_off = (torch.arange(n, dtype=torch.int32, device=dev) * nb)[:, None]
    glob = torch.where(all_ids == EMPTY, EMPTY, all_ids + rank_off)
    out_b = torch.zeros((M // block, *bshape), dtype=dense.dtype, device=dev)
    _coo_reduce(out_b.view(M // block, -1), glob, all_val, backend=backend)
    out = out_b.view(M, *vshape)
    wpb = block * _vwidth(dense[0]) + 1  # words per block on the wire
    nnz = _nnz(ids).view(local, n)
    sent = (nnz.sum(-1) - _own(nnz, group.rank_ids(dev))
            + (n - 1) * _nnz(pids)) * wpb
    overflow = ov.view(local, n).sum(-1, dtype=torch.int32) + ov_p
    return _expand(out, local), SyncStats(sent_words=sent, overflow=overflow)


def balanced_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup,
                  n: int, cap_push: int, cap_pull: int | None = None,
                  bins: int | None = None, backend: str = "torch"):
    """Load-balanced split-and-exchange allreduce (Ok-Topk family,
    arXiv 2201.07598).

    1. Compact local non-zero indices (budget ``n * cap_push``).
    2. Build a ``min(M, bins)``-bin equal-width histogram of the global
       non-zero multiset: one f32 allreduce of the local histograms.
    3. Assign contiguous bin ranges to destinations by the exclusive
       cumulative count, ``dest(j) = floor(cum(j) * n / total)`` (an f32
       multiply, an f32 divide, truncation).
    4. Split local non-zeros by destination, ``all_to_all`` the COO
       (global indices), scatter-add into a length-M buffer, compact the
       aggregated range (``cap_pull``, default ``cap_push``),
       ``all_gather`` the reduced shards.

    The histogram allreduce costs ``2 (n-1)/n * bins`` words, charged to
    ``sent_words``."""
    _check_n(group, n, "balanced_sync")
    local, M = dense.shape[:2]
    if cap_pull is None:
        cap_pull = cap_push
    B = min(M, bins or BALANCED_BINS)
    bw = -(-M // B)  # bin width (ceil), last bin may be ragged
    vw = _vwidth(dense[0])
    dev = dense.device

    # --- 1. local compaction -------------------------------------------------
    cap_local = n * cap_push
    idx, ov_c = compact_rows(_worker_mask(dense), cap_local)   # [local, n*cp]
    live = idx != EMPTY
    bin_of = torch.where(live, torch.where(live, idx, 0) // bw, B)

    # --- 2. global multiset histogram (f32 counts < 2^24: exact) -------------
    # counted by a scatter-add into B + 1 bins (the last takes the EMPTY
    # slots): bincount's output length depends on the data, a host sync
    # on the card
    b64 = bin_of.to(torch.int64)
    local_hist = torch.zeros((local, B + 1), dtype=torch.int64, device=dev
                             ).scatter_add_(1, b64, torch.ones_like(b64)
                                            )[:, :B].to(torch.float32)
    hist = group.psum(local_hist)                              # [local, B]
    hist_words = torch.full((), 2 * (n - 1) / n, dtype=torch.float32,
                            device=dev) * B

    # --- 3. balanced contiguous bin -> destination assignment ----------------
    cum = torch.cumsum(hist, dim=-1)
    total = torch.clamp(cum[:, -1:], min=1.0)
    excl = cum - hist                     # exclusive prefix counts
    dest_of_bin = torch.clamp((excl * n / total).to(torch.int32), 0, n - 1)
    dest = torch.where(
        live, torch.gather(dest_of_bin, 1,
                           bin_of.clamp(0, B - 1).to(torch.int64)), n)

    # --- 4. per-destination split + exchange ---------------------------------
    member = dest[:, None, :] == torch.arange(n, dtype=dest.dtype,
                                              device=dev)[None, :, None]
    lpos, ov_s = compact_rows(member.view(local * n, cap_local), cap_push)
    lpos, ov_s = lpos.view(local, n, cap_push), ov_s.view(local, n)
    pidx = torch.where(lpos == EMPTY, EMPTY, torch.gather(
        idx, 1, lpos.clamp(0, cap_local - 1).view(local, -1).to(torch.int64)
    ).view(local, n, cap_push))
    pval = _gather_stack(dense, pidx)
    got_idx = group.all_to_all(pidx)
    got_val = group.all_to_all(pval)

    # --- server aggregation over the full index space (global indices) -------
    buf = torch.zeros_like(dense)
    for s in range(local):
        _coo_reduce(buf[s], got_idx[s], got_val[s], backend=backend)

    # --- pull: compact the aggregated range, allgather the reduced shards ----
    pull_idx, pull_val, ov_p = _encode_rows(buf, cap_pull)
    del buf
    all_idx = group.all_gather(pull_idx)              # [n, cap_pull]
    all_val = group.all_gather(pull_val)
    out = _coo_reduce(torch.zeros_like(dense[0]), all_idx, all_val,
                      backend=backend)

    nnz_per_dest = (pidx != EMPTY).sum(-1).to(torch.float32)   # [local, n]
    push_sent = (nnz_per_dest.sum(-1)
                 - _own(nnz_per_dest, group.rank_ids(dev))) * (1 + vw)
    pull_sent = (n - 1) * _nnz(pull_idx) * (1 + vw)
    stats = SyncStats(sent_words=push_sent + pull_sent + hist_words,
                      overflow=ov_c + ov_s.sum(-1, dtype=torch.int32) + ov_p)
    return _expand(out, local), stats


# ---------------------------------------------------------------------------
# Zen: Balanced Parallelism via hierarchical hashing + hash bitmap
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZenLayout:
    """Offline, worker-shared state for one tensor shape: a pure function of
    (length, n, seeds) and the Alg. 1 capacities."""

    n: int
    length: int
    seeds: np.ndarray          # uint32 [k+1]
    perm: np.ndarray           # int32 [M]   (I_0 .. I_{n-1} concatenated)
    offsets: np.ndarray        # int32 [n+1]
    local_pos: np.ndarray      # int32 [M]   global idx -> rank inside its I_p
    cap_server: int            # max_i |I_i|
    cap_index: int             # C: worker-side nnz budget
    r1: int
    r2: int
    k: int

    @property
    def cap_bitmap_words(self) -> int:
        return (self.cap_server + 31) // 32

    @property
    def cap_pull(self) -> int:
        """Aggregated nnz kept per server (<= the sum of its pushes)."""
        return self.r1 + self.r2

    def static_seeds(self) -> tuple:
        return tuple(int(s) for s in self.seeds)

    def tables(self, device) -> dict:
        """perm / local_pos / offsets as int64 tensors on ``device``,
        uploaded once per device and cached on the layout."""
        cache = self.__dict__.setdefault("_tables", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = {
                name: torch.as_tensor(getattr(self, name).astype(np.int64),
                                      device=device)
                for name in ("perm", "local_pos", "offsets")}
        return cache[key]


def default_seeds(key: int, k: int) -> np.ndarray:
    """The port's own k+1 hash seeds: uint32 drawn from
    ``np.random.default_rng(key)`` in [1, 2**31 - 1).  The reference draws
    its seeds with JAX's threefry, so the two defaults differ; pass the
    reference layout's ``seeds`` to reproduce its partitions."""
    rng = np.random.default_rng(key)
    return rng.integers(1, 2**31 - 1, size=k + 1).astype(np.uint32)


_HASH_CHUNK = 1 << 24   # indices hashed at once on the host


def _hash_partitions(length: int, n: int, seed0: int):
    """(perm, offsets, local_pos, counts) of ``h0 mod n`` over [0, length):
    each partition's indices in ascending order, concatenated in partition
    order (what a stable argsort of the partition ids gives), one pass a
    partition."""
    p = np.empty(length, dtype=np.int32)
    for a in range(0, length, _HASH_CHUNK):
        idx = torch.arange(a, min(a + _HASH_CHUNK, length), dtype=torch.int32)
        p[a:a + idx.numel()] = hash_mod(idx, seed0, n).numpy()
    parts = [np.flatnonzero(p == j) for j in range(n)]
    del p
    counts = np.array([q.size for q in parts], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    perm = np.concatenate(parts).astype(np.int32)
    local = np.empty(length, dtype=np.int32)
    for q in parts:
        local[q] = np.arange(q.size, dtype=np.int32)
    return perm, offsets, local, counts


def make_zen_layout(length: int, n: int, *, density_budget: float,
                    key: int = 0, k: int = 3, r1_factor: float = 2.0,
                    r2_ratio: float = 0.1,
                    seeds: Sequence[int] | None = None) -> ZenLayout:
    """Precompute the Zen layout (offline, numpy).

    ``seeds`` (uint32 [k+1]) fixes the hash family; by default it is
    :func:`default_seeds` of ``key``, which differs from the reference's
    default for the same key.  Capacities follow the reference:
    ``C = max(32, ceil(length * density_budget))``,
    ``r1 = max(8, ceil(r1_factor * C / n))``, ``r2 = max(4, ceil(r2_ratio
    * r1))``."""
    seeds = (default_seeds(key, k) if seeds is None
             else np.asarray(seeds, dtype=np.uint32))
    if seeds.shape[0] < k + 1:
        raise ValueError(f"need {k + 1} seeds, got {seeds.shape[0]}")
    perm, offsets, local, counts = _hash_partitions(length, n, int(seeds[0]))
    cap_index = max(32, int(math.ceil(length * density_budget)))
    r1 = max(8, int(math.ceil(r1_factor * cap_index / n)))
    r2 = max(4, int(math.ceil(r2_ratio * r1)))
    return ZenLayout(n=n, length=length, seeds=seeds, perm=perm,
                     offsets=offsets, local_pos=local,
                     cap_server=int(counts.max()), cap_index=cap_index,
                     r1=r1, r2=r2, k=k)


class ZenEncoded(NamedTuple):
    """Output of ``zen_encode`` for the local workers: what the push
    needs."""

    pidx: torch.Tensor      # int32 [local, n_servers, r1+r2]
    pval: torch.Tensor      # [local, n_servers, r1+r2(, d)]
    overflow: torch.Tensor  # int32 [local]


def zen_encode(dense: torch.Tensor, *, layout: ZenLayout,
               backend: str = "torch", fused: bool = True) -> ZenEncoded:
    """Zen stage 1 on every local worker: compact its non-zero rows,
    hierarchically hash them into n partitions and gather their values.
    Collective-free.  ``fused`` runs one encode launch per worker; the
    unfused chain runs the hash stage, the insertion rounds and the
    extraction (``hierarchical_hash`` + ``extract_partitions``)."""
    check_backend(backend)
    lo = layout
    encode = kops.zen_encode_fused_op if backend == "cuda" else kref.zen_encode_ref
    idx, ov_c = compact_rows(_worker_mask(dense), lo.cap_index)      # [n, C]
    pidx, ovf = [], []
    for w in range(dense.shape[0]):
        if fused:
            p, _occ, o = encode(idx[w], lo.static_seeds(), lo.n, lo.r1, lo.r2)
        else:
            part = hierarchical_hash(idx[w], n=lo.n, r1=lo.r1, r2=lo.r2,
                                     k=lo.k, seeds=lo.static_seeds(),
                                     backend=backend)
            p, o = extract_partitions(part, backend=backend), part.overflow
        pidx.append(p)
        ovf.append(o)
    pidx = torch.stack(pidx)
    pval = torch.stack([_gather_rows(dense[w], pidx[w])
                        for w in range(dense.shape[0])])
    return ZenEncoded(pidx=pidx, pval=pval, overflow=ov_c + torch.stack(ovf))


def _push_unfused(lp: torch.Tensor, got_val: torch.Tensor, dense, lo,
                  backend: str):
    """The pre-fusion server aggregation of every local server:
    scatter-add into a zero [cap_server(, d)] buffer, mask any(row != 0),
    ascending compaction to cap_pull, value gather, and the server bitmap.
    Returns (lpos [local, cap_pull], vals [local, cap_pull(, d)], mask
    [local, cap_server], overflow [local])."""
    local = lp.shape[0]
    bufs = torch.zeros((local, lo.cap_server, *dense.shape[2:]),
                       dtype=dense.dtype, device=dense.device)
    for s in range(local):
        _coo_reduce(bufs[s], lp[s], got_val[s], backend=backend)
    mask = _worker_mask(bufs)
    lpos, ov_p = compact_rows(mask, lo.cap_pull)
    vals = torch.stack([_gather_rows(bufs[s], lpos[s])
                        for s in range(local)])
    return lpos, vals, mask, ov_p


def zen_commit(enc: ZenEncoded, dense: torch.Tensor, *,
               group: SimGroup | DistGroup, layout: ZenLayout,
               use_hash_bitmap: bool = True, backend: str = "torch",
               fused: bool = True):
    """Zen stages 2-4: push all_to_all, server aggregation, bitmap pull and
    the collision-free apply, for the local workers (each also the server
    of its rank).  ``fused`` runs one push launch per local server and one
    pull-decode launch per local worker; the unfused chain runs a
    scatter-add per local server, one pack of all local server masks and an
    unpack per local worker (straight into [n, cap_server]), with the
    compactions in plain torch.  ``dense`` gives only shapes and dtype."""
    check_backend(backend)
    lo, n = layout, group.n
    local, M = dense.shape[:2]
    vshape = tuple(dense.shape[2:])
    vw = _vwidth(dense[0])
    dev = dense.device
    tabs = lo.tables(dev)
    ranks = group.rank_ids(dev)
    push = (kops.zen_commit_push_fused_op if backend == "cuda"
            else kref.zen_commit_push_ref)
    pull = (kops.zen_commit_pull_fused_op if backend == "cuda"
            else kref.zen_commit_pull_ref)
    cap_pull = lo.cap_pull

    # --- 2. Push (balanced all_to_all) ---------------------------------------
    got_idx = group.all_to_all(enc.pidx).reshape(local, -1)   # [srv, n*L]
    got_val = group.all_to_all(enc.pval).reshape(local, -1, *vshape)
    live = got_idx != EMPTY
    lp = torch.where(live, tabs["local_pos"][torch.where(live, got_idx, 0)
                                             .to(torch.int64)],
                     lo.cap_server).to(torch.int32)

    # --- 3. server aggregation + pull payload --------------------------------
    if fused:
        lpos, vals, bms, ov_p = [], [], [], []
        for s in range(local):
            res = push(lp[s], got_val[s], cap_server=lo.cap_server,
                       cap_pull=cap_pull)
            for acc, x in zip((lpos, vals, bms, ov_p), res):
                acc.append(x)
        lpos, vals = torch.stack(lpos), torch.stack(vals)
        bms, ov_p = torch.stack(bms), torch.stack(ov_p)
    else:
        lpos, vals, srv_mask, ov_p = _push_unfused(lp, got_val, dense, lo,
                                                   backend)
        if use_hash_bitmap:   # all local server masks in one pack
            bms = formats.bitmap_encode(srv_mask, backend=backend)

    # --- 4. Pull --------------------------------------------------------------
    all_val = group.all_gather(vals).reshape(-1, *vshape)     # [n*cap_pull,..]
    if use_hash_bitmap:
        all_bm = group.all_gather(bms)                        # [n, W]
        globs = []
        for _w in range(local):   # every worker decodes all n bitmaps
            if fused:
                lpos_all = pull(all_bm, lo.cap_server, cap_pull)
            else:
                lpos_all = compact_rows(formats.bitmap_decode_batch(
                    all_bm, lo.cap_server, backend=backend), cap_pull)[0]
            gidx = (tabs["offsets"][:n, None] + lpos_all).clamp(0, M - 1)
            globs.append(torch.where(lpos_all == EMPTY, EMPTY,
                                     tabs["perm"][gidx]))
        pull_words = (n - 1) * (_nnz(lpos) * vw + lo.cap_bitmap_words)
    else:  # COO pull (the Fig. 18 ablation)
        gidx = (tabs["offsets"][ranks, None] + lpos).clamp(0, M - 1)
        glob = group.all_gather(
            torch.where(lpos == EMPTY, EMPTY, tabs["perm"][gidx]))
        globs = [glob] * local
        pull_words = (n - 1) * _nnz(lpos) * (vw + 1)
    out = torch.stack([
        _scatter_unique(torch.zeros_like(dense[w]), globs[w].reshape(-1),
                        all_val) for w in range(local)])

    nnz = _nnz(enc.pidx)                                      # [worker, srv]
    own = nnz[torch.arange(local, device=dev), ranks]
    push_sent = (nnz.sum(-1) - own) * (1 + vw)
    stats = SyncStats(sent_words=push_sent + pull_words,
                      overflow=enc.overflow + ov_p)
    return out, stats


def zen_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup,
             layout: ZenLayout, use_hash_bitmap: bool = True,
             backend: str = "torch", fused: bool = True,
             fused_commit: bool = True):
    """Zen synchronization of [local, M(, d)] worker gradients: Alg. 1
    push + Alg. 2 (hash bitmap) pull; ``use_hash_bitmap=False`` pulls COO.
    ``fused`` / ``fused_commit`` pick the encode / commit kernel route."""
    enc = zen_encode(dense, layout=layout, backend=backend, fused=fused)
    return zen_commit(enc, dense, group=group, layout=layout,
                      use_hash_bitmap=use_hash_bitmap, backend=backend,
                      fused=fused_commit)


# ---------------------------------------------------------------------------
# CommPlan execution: per-stage dispatch and capacity provisioning
# ---------------------------------------------------------------------------

def stage_sync(scheme: str, dense: torch.Tensor, *,
               group: SimGroup | DistGroup, n: int,
               stage_args: StageArgs | None = None, **kw):
    """Run one scheme over ``group``: the uniform entry GradSync's bucket
    committer dispatches through.

    Dispatch is registry-driven (``core/registry.py``): the scheme's
    :class:`SchemeSpec` names the executable function, the
    :class:`StageArgs` fields it consumes, and which are mandatory.
    Callers pass either a typed ``stage_args`` or loose keyword arguments
    (collected into one); validation raises config-named ValueErrors
    before any collective runs.  ``interpret`` (a field kept for the
    reference's field set) is never passed on: the port has no interpret
    mode."""
    spec = sreg.get_scheme(scheme)
    if stage_args is None:
        try:
            stage_args = StageArgs(**kw)
        except TypeError:
            valid = ", ".join(f.name for f in dataclasses.fields(StageArgs))
            bad = ", ".join(sorted(set(kw) - {
                f.name for f in dataclasses.fields(StageArgs)}))
            raise ValueError(
                f"stage_sync({scheme!r}): unknown stage arg(s) {bad}; "
                f"StageArgs fields are: {valid}") from None
    elif kw:
        raise ValueError(
            "stage_sync: pass a typed stage_args OR loose keyword "
            f"arguments, not both (got stage_args and {sorted(kw)})")
    sreg.validate_stage_args(spec, stage_args,
                             where=f"stage over a group of {n}")
    kwargs = sreg.stage_kwargs(spec, stage_args)
    kwargs.pop("interpret", None)
    if spec.needs_n:
        kwargs["n"] = n
    return spec.resolve_sync()(dense, group=group, **kwargs)


def level_budget(topology, budget: float, level: int) -> float:
    """Capacity budget for a plan stage at ``level``: stages after the
    intra merge provision for the worst-case merged density (the product
    of earlier level sizes' non-overlapping non-zeros in one tensor).
    Level 0 passes the configured budget through untouched."""
    if level == 0:
        return budget
    grow = math.prod(lv.size for lv in topology.levels[:level])
    return min(1.0, budget * grow)


def stage_args_for(scheme: str, *, rows: int, budget: float,
                   layout: ZenLayout | None = None,
                   use_hash_bitmap: bool = True, backend: str = "torch",
                   interpret: bool | None = None, fused: bool | None = None,
                   fused_commit: bool | None = None) -> StageArgs:
    """Provision one stage's :class:`StageArgs` from a density budget: the
    one place capacity sizing lives (GradSync and the tests route through
    it).  ``cap = max(64, rows * budget)``, with omnireduce's block split
    as the reference provisions it.  The aggregating schemes carry
    ``backend``, their server aggregation's kernel route."""
    cap = max(64, int(rows * budget))
    if scheme == "dense":
        return StageArgs()
    if scheme == "zen":
        return StageArgs(layout=layout, use_hash_bitmap=use_hash_bitmap,
                         backend=backend, interpret=interpret, fused=fused,
                         fused_commit=fused_commit)
    if scheme == "omnireduce":
        blk = 8
        nb = max(8, cap // blk)
        return StageArgs(block=blk, cap_push=nb, cap_pull=nb, backend=backend)
    # COO-capacity family: agsparse, sparcml, sparse_ps, balanced; the
    # registry's arg aliases fan ``capacity`` into cap_push/cap_pull
    return StageArgs(capacity=cap, backend=backend)


def plan_stage_args(plan, topology, rows: int, *, density_budget: float,
                    key: int = 0, k: int = 3, r1_factor: float = 2.0,
                    r2_ratio: float = 0.1, backend: str = "torch",
                    use_hash_bitmap: bool = True, fused: bool | None = None,
                    fused_commit: bool | None = None,
                    interpret: bool | None = None,
                    seeds: Sequence[int] | None = None) -> dict[int, StageArgs]:
    """Provision every stage of a CommPlan: {level -> StageArgs}, size-1
    levels skipped (free identity) and capacity grown across the
    intra-merge boundary via :func:`level_budget`.  Zen stages get a fresh
    layout sized for the level's merged budget (hash ``seeds`` as in
    :func:`make_zen_layout`).  Each stage is validated against the
    registry, so a bad plan fails here with the level named."""
    out: dict[int, StageArgs] = {}
    for stage in plan.stages:
        lvl = topology.levels[stage.level]
        if lvl.size <= 1:
            continue
        b = level_budget(topology, density_budget, stage.level)
        layout = None
        if stage.scheme == "zen":
            layout = make_zen_layout(rows, lvl.size, density_budget=b,
                                     key=key, k=k, r1_factor=r1_factor,
                                     r2_ratio=r2_ratio, seeds=seeds)
        args = stage_args_for(
            stage.scheme, rows=rows, budget=b, layout=layout,
            use_hash_bitmap=use_hash_bitmap, backend=backend,
            interpret=interpret, fused=fused, fused_commit=fused_commit)
        sreg.validate_stage_args(
            sreg.get_scheme(stage.scheme), args,
            where=f"plan stage {stage.scheme}@level{stage.level}")
        out[stage.level] = args
    return out


def simulate(fn, per_worker_dense: torch.Tensor, **kwargs):
    """Run a scheme over [n, M(, d)] worker gradients on a simulated group
    of n workers: (aggregated [n, M(, d)], per-worker SyncStats)."""
    return fn(per_worker_dense, group=SimGroup(per_worker_dense.shape[0]),
              **kwargs)


# ---------------------------------------------------------------------------
# Two-level execution: one group per topology level
# ---------------------------------------------------------------------------

class Held:
    """The ``[local, ...]`` per-worker values between the levels of a
    multi-level sync, held as distinct tensors ``vals`` and each local
    worker's index into them (``rep``).  After a level whose scheme hands
    every worker of a group one shared tensor (a psum, agsparse's reduce),
    that group's workers share one entry, so the next level's groups that
    see the same inputs run once; ``base`` is the stack itself while no
    level has run."""

    def __init__(self, vals: list, rep: list[int], base=None):
        self.vals, self.rep, self.base = vals, rep, base

    @classmethod
    def of(cls, x: torch.Tensor) -> "Held":
        return cls(list(x.unbind(0)), list(range(x.shape[0])), base=x)

    def take(self, rows: list[int]) -> torch.Tensor:
        """The ``[len(rows), ...]`` stack of these workers' values (a view
        of ``base`` for consecutive rows)."""
        a = rows[0]
        if self.base is not None and rows == list(range(a, a + len(rows))):
            return self.base[a:a + len(rows)]
        return torch.stack([self.vals[self.rep[r]] for r in rows])

    def map(self, fn) -> "Held":
        """``fn`` applied to every distinct value (once each)."""
        return Held([fn(v) for v in self.vals], list(self.rep))

    def stack(self) -> torch.Tensor:
        """The ``[local, ...]`` values: one tensor expanded when every
        worker holds the same one, as a psum's output is."""
        if self.base is not None:
            return self.base
        if len(set(self.rep)) == 1:
            v = self.vals[self.rep[0]]
            return v[None].expand(len(self.rep), *v.shape)
        return torch.stack([self.vals[i] for i in self.rep])


def level_sync(held: Held, group: SimGroup | DistGroup, sizes: Sequence[int],
               axis: int, fn) -> tuple[Held, SyncStats]:
    """Run ``fn(x [s, ...], subgroup, rows) -> (out [s, ...], SyncStats)``
    on every group of level ``axis`` of the world laid out as ``sizes``
    (``group.split``).  Groups whose inputs are the same tensors run once
    and share the result: the same inputs on the same ranks give the same
    bits.  Returns the workers' outputs and per-worker stats."""
    local = len(held.rep)
    vals: list = []
    rep: list = [0] * local
    sent: list = [None] * local
    ovf: list = [None] * local
    done: dict = {}
    for rows, sub in group.split(sizes, axis):
        key = tuple(held.rep[r] for r in rows)
        if key not in done:
            out, st = fn(held.take(rows), sub, rows)
            if len(rows) > 1 and out.stride(0) == 0:   # one shared value
                idx = [len(vals)] * len(rows)
                vals.append(out[0])
            else:
                idx = list(range(len(vals), len(vals) + len(rows)))
                vals.extend(out.unbind(0))
            done[key] = idx, st
        idx, st = done[key]
        for j, r in enumerate(rows):
            rep[r] = idx[j]
            sent[r], ovf[r] = st.sent_words[j], st.overflow[j]
    return Held(vals, rep), SyncStats(sent_words=torch.stack(sent),
                                      overflow=torch.stack(ovf))


def world_sizes(topology, pods: int = 1) -> tuple[int, ...]:
    """The world's mixed-radix layout, outermost first: ``(pods, *levels
    slowest first)``; topology level ``L`` is digit ``len - 1 - L``."""
    return (pods, *(lv.size for lv in reversed(topology.levels)))


def hier_sync(dense: torch.Tensor, *, group: SimGroup | DistGroup, topology,
              plan, stage_kw: dict | None = None):
    """Execute a CommPlan over a Topology: stage 0 aggregates over the fast
    (intra) level's groups, stage 1 runs on the *intra-aggregated*
    gradient over the slow (inter) level's.  Exact by associativity of the
    sum.

    ``group`` holds the whole data-parallel world (``topology.n`` ranks:
    the in-process ``SimGroup`` splits its stack, a ``DistGroup`` runs
    this rank's group of each level).  ``stage_kw`` maps a level index to
    its stage's arguments, a typed :class:`StageArgs` (what
    :func:`plan_stage_args` builds) or a loose kwargs dict.  Size-1 levels
    are skipped and report zero words.  Returns the SUM over all workers
    (the convention of every flat ``*_sync``) with ``SyncStats.by_level``
    carrying the per-level wire words."""
    stage_kw = stage_kw or {}
    sizes = world_sizes(topology)
    held = Held.of(dense)
    sent, overflow, _ = zero_stats(dense.shape[0], dense.device)
    by_level = []
    for stage in plan.stages:
        lvl = topology.levels[stage.level]
        if lvl.size <= 1:
            by_level.append(torch.zeros_like(sent))
            continue
        kw = stage_kw.get(stage.level, {})
        kw = ({"stage_args": kw} if isinstance(kw, StageArgs) else kw)

        def run(x, sub, _rows, scheme=stage.scheme, n=lvl.size, kw=kw):
            return stage_sync(scheme, x, group=sub, n=n, **kw)

        held, st = level_sync(held, group, sizes,
                              len(sizes) - 1 - stage.level, run)
        sent = sent + st.sent_words
        overflow = overflow + st.overflow
        by_level.append(st.sent_words)
    return held.stack(), SyncStats(sent_words=sent, overflow=overflow,
                                   by_level=tuple(by_level))


def simulate_hier(per_worker_dense: torch.Tensor, *, topology, plan,
                  stage_kw: dict | None = None):
    """A hierarchical plan over [n, M(, d)] worker gradients on the
    in-process group: a node's workers are CONSECUTIVE rows (the grouping
    ``launch/mesh.py`` builds).  Returns (aggregated [n, M(, d)],
    per-worker SyncStats with ``by_level``)."""
    return hier_sync(per_worker_dense,
                     group=SimGroup(per_worker_dense.shape[0]),
                     topology=topology, plan=plan, stage_kw=stage_kw)
