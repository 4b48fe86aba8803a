"""Sparse tensor formats (§3.2): COO, bitmap, tensor blocks, hash bitmap.

Port of ``repro.core.formats``.  Every format has a fixed capacity
(EMPTY-padded indices, an overflow count of what did not fit).  Values
are scalars (element-sparse, ``[M]``) or rows of width ``d`` (row-sparse,
``[M, d]``).

Bitmaps are packed LSB first: bit ``j`` of word ``w`` is position ``32 w
+ j``.  A word is held as an ``int32`` tensor carrying the same 32 bits as
the reference's ``uint32`` word (PyTorch has few ``uint32`` operations);
``.numpy().view(np.uint32)`` gives the reference's words back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import (EMPTY, check_backend, compact_indices,
                                      compact_rows, hash_mod)

BITS = 32


def _weights(device) -> torch.Tensor:
    return torch.bitwise_left_shift(
        torch.ones(BITS, dtype=torch.int64, device=device),
        torch.arange(BITS, dtype=torch.int64, device=device))


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """bool/int [r, L] -> int32 [r, ceil(L/32)] words, LSB first."""
    r, L = bits.shape
    W = -(-L // BITS)
    padded = torch.zeros((r, W * BITS), dtype=torch.int64, device=bits.device)
    padded[:, :L] = bits.to(torch.int64)
    words = (padded.view(r, W, BITS) * _weights(bits.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def bitmap_encode(mask: torch.Tensor, *, backend: str = "torch") -> torch.Tensor:
    """bool [M] -> int32 [ceil(M/32)] packed words, or [n, M] -> [n,
    ceil(M/32)], each row packed alone.  ``backend="cuda"`` routes through
    the pack kernel, one launch for all rows
    (``kernels/ops.py::bitmap_pack_rows_op``; its plain version for a CPU
    tensor), with the same words."""
    check_backend(backend)
    rows = mask if mask.ndim == 2 else mask[None]
    if backend == "cuda":
        from repro_torch.kernels import ops  # deferred: kernels import core

        words = ops.bitmap_pack_rows_op(rows)
    else:
        words = pack_rows(rows)
    return words if mask.ndim == 2 else words[0]


def bitmap_decode(words: torch.Tensor, length: int, *,
                  backend: str = "torch") -> torch.Tensor:
    """int32 [W] words -> bool [length]."""
    return bitmap_decode_batch(words[None], length, backend=backend)[0]


def bitmap_decode_batch(words: torch.Tensor, length: int, *,
                        backend: str = "torch") -> torch.Tensor:
    """int32 [n, W] words -> bool [n, length]: every server bitmap at once
    (``backend="cuda"``: one unpack launch straight into [n, length])."""
    check_backend(backend)
    if backend == "cuda":
        from repro_torch.kernels import ops  # deferred: kernels import core

        return ops.bitmap_unpack_rows_op(words, length)
    n, W = words.shape
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, :, None] & _weights(words.device)) != 0
    return bits.reshape(n, W * BITS)[:, :length]


def bitmap_decode_compact(words: torch.Tensor, length: int,
                          capacity: int) -> torch.Tensor:
    """int32 [n, W] -> int32 [n, capacity]: each bitmap's set-bit positions
    below ``length``, ascending, EMPTY-padded (the zen pull decode)."""
    return compact_rows(bitmap_decode_batch(words, length), capacity)[0]


def bitmap_wire_bytes(length: int) -> int:
    return ((length + BITS - 1) // BITS) * 4


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------

def _row_mask(dense: torch.Tensor) -> torch.Tensor:
    """Non-zero mask of ``[M]`` elements or ``[M, ...]`` rows."""
    return dense != 0 if dense.ndim == 1 else \
        (dense != 0).reshape(dense.shape[0], -1).any(dim=1)


def _take(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dense[idx]`` with EMPTY -> zeros."""
    dead = idx == EMPTY
    vals = dense.index_select(0, torch.where(dead, 0, idx).to(torch.int64))
    dead = dead.reshape(-1, *([1] * (dense.ndim - 1)))
    return torch.where(dead, torch.zeros((), dtype=vals.dtype,
                                         device=vals.device), vals)


class COO(NamedTuple):
    """Fixed-capacity coordinate list; ``indices`` EMPTY-padded."""

    indices: torch.Tensor   # int32 [C]
    values: torch.Tensor    # [C] or [C, d]
    overflow: torch.Tensor  # int32 scalar: nnz beyond capacity (dropped)

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    def nnz(self) -> torch.Tensor:
        return (self.indices != EMPTY).sum(dtype=torch.int32)

    def wire_bytes(self) -> torch.Tensor:
        """4 B index + 4 B a value element per non-zero."""
        per = 1 if self.values.ndim == 1 else self.values.shape[-1]
        return self.nnz() * (4 + 4 * per)


def coo_encode(dense: torch.Tensor, capacity: int) -> COO:
    """Dense [M] or [M, d] -> COO with ``capacity`` slots (ascending)."""
    idx, overflow = compact_indices(_row_mask(dense), capacity)
    return COO(indices=idx, values=_take(dense, idx), overflow=overflow)


def coo_decode(coo: COO, length: int) -> torch.Tensor:
    """COO -> dense [length(, d)]: a scatter-add in stream order, so
    duplicate indices aggregate (the server-side aggregation)."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    shape = (length,) if coo.values.ndim == 1 else \
        (length, coo.values.shape[-1])
    out = torch.zeros(shape, dtype=coo.values.dtype,
                      device=coo.values.device)
    return ops.batched_coo_reduce_op(out, coo.indices, coo.values)


# ---------------------------------------------------------------------------
# Tensor blocks (OmniReduce's format)
# ---------------------------------------------------------------------------

class Blocks(NamedTuple):
    """Non-zero blocks of ``block`` consecutive gradients each."""

    block_ids: torch.Tensor  # int32 [C] EMPTY-padded
    values: torch.Tensor     # [C, block(, d)]
    overflow: torch.Tensor   # int32 scalar

    def n_blocks(self) -> torch.Tensor:
        return (self.block_ids != EMPTY).sum(dtype=torch.int32)

    def wire_bytes(self) -> torch.Tensor:
        per = self.values.shape[1:].numel()
        return self.n_blocks() * (4 + 4 * per)


def blocks_encode(dense: torch.Tensor, block: int, capacity: int) -> Blocks:
    """Dense [M(, d)] -> the ascending non-zero blocks of ``block`` rows,
    ``capacity`` slots."""
    m = dense.shape[0]
    if m % block:
        raise ValueError(f"blocks_encode: pad the tensor to a multiple of "
                         f"block={block}, got M={m}")
    blocked = dense.reshape(m // block, block, *dense.shape[1:])
    ids, overflow = compact_indices(_row_mask(blocked), capacity)
    return Blocks(block_ids=ids, values=_take(blocked, ids),
                  overflow=overflow)


def blocks_decode(blocks: Blocks, length: int) -> torch.Tensor:
    """Blocks -> dense [length(, d)] (duplicate blocks aggregate)."""
    from repro_torch.kernels import ops  # deferred: kernels import core

    block = blocks.values.shape[1]
    nb = length // block
    out = torch.zeros((nb, *blocks.values.shape[1:]),
                      dtype=blocks.values.dtype, device=blocks.values.device)
    ops.batched_coo_reduce_op(out.reshape(nb, -1), blocks.block_ids,
                              blocks.values)
    return out.reshape(length, *blocks.values.shape[2:])


# ---------------------------------------------------------------------------
# Hash bitmap (§3.2.2, Alg. 2)
# ---------------------------------------------------------------------------

class HashBitmapLayout(NamedTuple):
    """Offline layout shared by all workers and servers.

    ``perm``: int32 [M], the indices sorted by (h0(idx), idx): the
    concatenation of the per-server ordered sets I_0 .. I_{n-1}.
    ``counts``: int32 [n], |I_i| per server.
    ``offsets``: int32 [n+1], the prefix sum of counts.
    """

    perm: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor

    @property
    def n(self) -> int:
        return self.counts.shape[0]


def make_hash_bitmap_layout(length: int, n: int, seeds) -> HashBitmapLayout:
    """I_i = {idx : h0(idx) = i}, ascending, computed once offline;
    ``seeds[0]`` is h0's seed (uint32)."""
    idx = torch.arange(length, dtype=torch.int32)
    p = hash_mod(idx, int(seeds[0]), n)
    order = torch.argsort(p, stable=True)   # ascending idx within I_i
    counts = torch.bincount(p, minlength=n).to(torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    return HashBitmapLayout(perm=order.to(torch.int32), counts=counts,
                            offsets=offsets)


def hash_bitmap_encode(dense: torch.Tensor,
                       layout: HashBitmapLayout) -> torch.Tensor:
    """Alg. 2 encode, all servers at once: int32 [ceil(M/32)] words.
    Server i's bits are positions [offsets[i], offsets[i+1]) of the
    permuted mask; M/32 words in all, whatever n (Thm. 3)."""
    mask = _row_mask(dense)
    return bitmap_encode(mask[layout.perm.to(torch.int64)])


def hash_bitmap_decode(words: torch.Tensor,
                       layout: HashBitmapLayout) -> torch.Tensor:
    """Alg. 2 decode: packed words -> bool [M] global non-zero mask."""
    M = layout.perm.shape[0]
    permuted = bitmap_decode(words, M)
    mask = torch.zeros(M, dtype=torch.bool, device=words.device)
    mask[layout.perm.to(torch.int64)] = permuted
    return mask


def hash_bitmap_wire_bytes(length: int) -> int:
    """Thm. 3: a constant |G|/32 words, |G|/8 bytes, across all servers."""
    return ((length + BITS - 1) // BITS) * 4
