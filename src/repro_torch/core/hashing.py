"""Universal hashing and the hierarchical hashing algorithm (Zen, Alg. 1).

Port of ``repro.core.hashing``.  The insertion rounds are round-synchronous:
in round ``i`` every pending index proposes slot ``h_i(idx)`` of its
partition if that slot is still empty, and an ``amin`` scatter resolves the
race (the minimum proposer wins).  The serial memory assigns ranks in
candidate order with a segmented cumulative sum.

The plain path hashes in int64 masked to 32 bits, because PyTorch has no
``>>`` or ``%`` for ``uint32`` on the CPU; the CUDA kernel
(``csrc/zen_encode.cu``) computes the same bits in native ``uint32``.
Index sets are ``int32`` vectors padded with ``EMPTY`` (int32 max).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

EMPTY = 2**31 - 1  # sentinel for "no index in this slot"
# kernel routes: "cuda" goes through kernels/ops.py (the CUDA kernels for
# CUDA tensors, their plain versions for CPU tensors), "torch" runs the
# plain versions everywhere
BACKENDS = ("torch", "cuda")

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) without int64
    overflow: the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer on int64 values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded hash of int32 ``x``: the uint32 result as int64 in [0, 2**32)."""
    seed = int(seed) & _MASK32
    h = fmix32((x.to(torch.int64) & _MASK32) ^ seed)
    mix = ((seed * 0x9E3779B9) & _MASK32) ^ 0x5BD1E995
    return fmix32(h ^ mix)


def hash_mod(x: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    """``h(x) mod m`` as int32 in ``[0, m)``."""
    return (hash_u32(x, seed) % m).to(torch.int32)


class HashPartition(NamedTuple):
    """Alg. 1's ``n x (r1 + r2)`` index memory (EMPTY-padded), the count of
    indices the serial memory could not hold, and a per-round histogram of
    successful writes (round k is the serial memory)."""

    memory: torch.Tensor      # int32 [n, r1 + r2]
    overflow: torch.Tensor    # int32 scalar
    rounds_used: torch.Tensor  # int32 [k + 1]


def partition_rank(p: torch.Tensor, surv: torch.Tensor, n: int) -> torch.Tensor:
    """Rank of each surviving entry among the survivors of its partition, in
    candidate order (Alg. 1's serial-memory counter); dead entries get -1."""
    parts = torch.arange(n, dtype=p.dtype, device=p.device)
    onehot = (p[:, None] == parts[None, :]) & surv[:, None]
    seg = torch.cumsum(onehot.to(torch.int32), dim=0) - 1          # [C, n]
    safe_p = p.clamp(0, n - 1).to(torch.int64)
    rank = torch.gather(seg, 1, safe_p[:, None])[:, 0]
    return torch.where(surv, rank, torch.full_like(rank, -1))


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def hierarchical_hash(indices: torch.Tensor, *, n: int, r1: int, r2: int,
                      k: int, seeds: Sequence[int],
                      backend: str = "torch") -> HashPartition:
    """Algorithm 1 on unique EMPTY-padded int32 ``indices`` [C].

    ``seeds`` holds k+1 uint32 values: ``seeds[0]`` is ``h0`` (the partition
    hash every worker must share), ``seeds[1:]`` are ``h1..hk``.
    ``backend="cuda"`` takes p and the k candidate slots from the hash-stage
    kernel (``kernels/ops.py::hash_stage_op``); the insertion rounds and the
    serial rank stay in plain torch on both routes."""
    check_backend(backend)
    seeds = [int(s) for s in seeds]
    if len(seeds) < k + 1:
        raise ValueError(f"need {k + 1} seeds, got {len(seeds)}")
    row = r1 + r2
    dev = indices.device
    valid = indices != EMPTY
    if backend == "cuda":
        from repro_torch.kernels import ops  # deferred: kernels/ref.py imports us

        p, q = ops.hash_stage_op(indices, seeds[:k + 1], n, r1)
        qs = list(q.clamp(0, r1 - 1))   # EMPTY's r1 sentinel never proposes
    else:
        p = hash_mod(indices, seeds[0], n)
        qs = [hash_mod(indices, seeds[i], r1) for i in range(1, k + 1)]
    p = p.clamp(0, n - 1).to(torch.int64)
    # one extra dump slot at n*row takes the serial writes that do not fit
    memory = torch.full((n * row + 1,), EMPTY, dtype=torch.int32, device=dev)
    empty = torch.full_like(indices, EMPTY)
    pending = valid
    rounds = []
    for q in qs:
        slot = p * row + q.to(torch.int64)
        propose = pending & (memory[slot] == EMPTY)
        cand = torch.where(propose, indices, empty)
        memory.scatter_reduce_(0, slot, cand, "amin")
        won = propose & (memory[slot] == indices)
        rounds.append(won.sum(dtype=torch.int32))
        pending = pending & ~won
    surv = pending
    rank = partition_rank(p, surv, n)
    fits = surv & (rank < r2)
    slot = torch.where(fits, p * row + r1 + rank.clamp(0, r2 - 1), n * row)
    memory.scatter_(0, slot, torch.where(fits, indices, empty))
    rounds.append(fits.sum(dtype=torch.int32))
    overflow = (surv & ~fits).sum(dtype=torch.int32)
    return HashPartition(memory=memory[:n * row].view(n, row),
                         overflow=overflow,
                         rounds_used=torch.stack(rounds))


def row_compact(mem: torch.Tensor) -> torch.Tensor:
    """Live entries to the front of each row in slot order, EMPTY tail."""
    valid = mem != EMPTY
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    L = mem.shape[1]
    out = torch.full((mem.shape[0], L + 1), EMPTY, dtype=mem.dtype,
                     device=mem.device)
    out.scatter_(1, torch.where(valid, pos, L), mem)   # dead -> dump column
    return out[:, :L].contiguous()


def extract_partitions(part: HashPartition, *,
                       backend: str = "torch") -> torch.Tensor:
    """Alg. 1 lines 19-23: each partition's live indices compacted to the
    front in slot order, EMPTY-padded: int32 [n, r1+r2].
    ``backend="cuda"`` runs the row-compaction kernel."""
    check_backend(backend)
    if backend == "cuda":
        from repro_torch.kernels import ops  # deferred: kernels/ref.py imports us

        return ops.row_compact_op(part.memory)
    return row_compact(part.memory)


def strawman_hash(indices: torch.Tensor, *, n: int, r: int,
                  seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Appendix A, Alg. 3: one universal hash into an ``n x r`` memory;
    colliding indices lose (the smallest index keeps the slot).

    Returns (memory int32 [n, r], lost count int32), the Fig. 8 / Fig. 14
    baseline of the information-loss-vs-memory dilemma."""
    valid = indices != EMPTY
    slot = (hash_u32(indices, seed) % (n * r)).to(torch.int64)
    memory = torch.full((n * r,), EMPTY, dtype=torch.int32,
                        device=indices.device)
    memory.scatter_reduce_(0, slot, torch.where(valid, indices, EMPTY),
                           "amin")
    survived = valid & (memory[slot] == indices)
    lost = (valid & ~survived).sum(dtype=torch.int32)
    return memory.view(n, r), lost


def compact_indices(mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions where ``mask`` is True, ascending, as an EMPTY-padded int32
    [capacity] vector, plus the count dropped beyond ``capacity``."""
    out, overflow = compact_rows(mask[None], capacity)
    return out[0], overflow[0]


def compact_rows(mask: torch.Tensor,
                 capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise :func:`compact_indices`: bool [r, M] -> (int32 [r, capacity],
    int32 [r] overflow).  One row at a time, so its int64 positions take
    8 M bytes, not 8 r M."""
    nnz = mask.sum(dim=1, dtype=torch.int32)
    src = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    out = torch.full((mask.shape[0], capacity + 1), EMPTY, dtype=torch.int32,
                     device=mask.device)
    for i in range(mask.shape[0]):
        pos = torch.cumsum(mask[i], 0, dtype=torch.int64) - 1
        tgt = torch.where(mask[i] & (pos < capacity), pos, capacity)
        out[i].scatter_(0, tgt, src)              # rest -> dump column
    return out[:, :capacity].contiguous(), (nnz - capacity).clamp(min=0)
