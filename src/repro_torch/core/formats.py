"""Packed bitmaps for the Zen hash-bitmap pull (§3.2.1, Alg. 2).

Port of the bitmap half of ``repro.core.formats``.  Bits are packed LSB
first: bit ``j`` of word ``w`` is position ``32 w + j``.  A word is held as
an ``int32`` tensor carrying the same 32 bits as the reference's ``uint32``
word (PyTorch has few ``uint32`` operations); ``.numpy().view(np.uint32)``
gives the reference's words back.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import check_backend, compact_rows

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
