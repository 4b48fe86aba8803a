"""Wrappers around the port's CUDA kernels, with their launch counters.

Port of the dispatch half of ``repro.kernels.ops``.  Each wrapper takes the
device from its tensors: a CUDA tensor launches the hand-written kernel
(``csrc/``) or raises; a CPU tensor takes the kernel's plain version in
``kernels/ref.py``.  There is no fallback from a failed launch.

``LAUNCHES[name]`` counts kernel launches and ``PLAIN_CALLS[name]`` counts
calls that took the plain version; ``RECOMPUTE_CALLS[name]`` counts the
plain backward passes of the autograd Functions over the model kernels
(``SSDScan``'s plain scan re-run to differentiate, ``FlashAttn``'s
``ref.flash_bwd_ref``); ``reset_counts()`` zeroes all three.  The
counters are plain integers so a run can show which route its path took;
``path_kernels`` names the kernels a Zen sync route launches.

A meta tensor (the dry run's, ``launch/dryrun.py``) takes neither: the
wrapper makes the kernel's own checks of shapes, dtypes and domain (a
shape the card would refuse raises the same ``ValueError``) and returns
empty meta outputs of the kernel's shapes and dtypes, counted nowhere.
:func:`kernel_cost` gives a call's operations and bytes from its shapes.

``TRACE`` is the op trace recording a sync (``analysis/trace_ir.OpTrace``)
or a step (``launch/trace_cost.CostMode``), or None.  While it is set,
each wrapper call, on any route, is one opaque ``kernel:<name>`` record
of that trace: the ops of its plain version (the CPU route, or the
``"torch"`` route of ``batched_coo_reduce_op``) are the kernel's, not the
sync's own.  Nothing else changes: the same calls, the same results.

Two kernel sets carry the Zen sync.  The fused route (the default) runs the
three megakernels; the unfused route (``SyncConfig(fused_encode=False)``
and/or ``fused_commit=False``) runs the pre-fusion chain of five smaller
kernels, whose compositions ``zen_encode_unfused``,
``zen_commit_push_unfused`` and ``zen_commit_pull_unfused`` give the fused
kernels' outputs bit for bit.  ``coo_scatter_add`` is also every
baseline scheme's server aggregation (``batched_coo_reduce_op``).  Two
more carry the models: ``flash_fwd`` (attention) and ``ssd_fwd`` (the
Mamba2 scan), in prefill and, under autograd, in training (``FlashAttn``
in every attention of every trainer, ``SSDScan`` in the Mamba2 layers).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from repro_torch.core.hashing import (EMPTY, check_backend, compact_indices,
                                      compact_rows, hierarchical_hash)
from repro_torch.kernels import _build
from repro_torch.kernels import ref

BITS = 32
FUSED_KERNELS = ("zen_encode", "zen_commit_push", "zen_commit_pull")
UNFUSED_KERNELS = ("hash_stage", "row_compact", "coo_scatter_add",
                   "bitmap_pack", "bitmap_unpack")
MODEL_KERNELS = ("flash_fwd", "ssd_fwd")
KERNELS = FUSED_KERNELS + UNFUSED_KERNELS + MODEL_KERNELS
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
RECOMPUTE_CALLS = {"flash_fwd": 0, "ssd_fwd": 0}
TRACE = None


def _opaque(name: str):
    """A wrapper that the active ``TRACE`` logs as one ``kernel:<name>``
    record (``OpTrace.kernel``); without a trace, the wrapper itself."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if TRACE is None:
                return fn(*args, **kwargs)
            return TRACE.kernel(name, fn, args, kwargs)
        return call
    return deco

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "zen_encode": {
        "zen_encode_launch": (
            [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
        "zen_encode_smem_bytes": ([_I, _I, _I], _I),
        "zen_encode_gscratch": ([_I, _I, _I, _I], _LL),
        "zen_encode_wide": ([_I, _I, _I], _I),
        "zen_encode_error_string": ([_I], ctypes.c_char_p),
    },
    "zen_commit": {
        "zen_commit_push_launch": (
            [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
            _I),
        "zen_commit_push_zscratch": ([_I], _LL),
        "zen_commit_push_iscratch": ([_I, _I], _LL),
        "zen_commit_push_wide": ([_I], _I),
        "zen_commit_push_grid": ([_I, _I, _I, _I, _I, _P, _P, _P], _I),
        "zen_commit_pull_zscratch": ([], _LL),
        "zen_commit_pull_iscratch": ([_I, _I], _LL),
        "zen_commit_pull_launch": ([_P, _I, _I, _I, _I, _P, _P, _P, _P],
                                   _I),
        "zen_commit_error_string": ([_I], ctypes.c_char_p),
    },
    "hash_stage": {
        "hash_stage_launch": ([_P, _I, _P, _I, _I, _I, _P, _P, _P], _I),
        "hash_stage_error_string": ([_I], ctypes.c_char_p),
    },
    "row_compact": {
        "row_compact_launch": ([_P, _I, _I, _P, _P], _I),
        "row_compact_error_string": ([_I], ctypes.c_char_p),
    },
    "bitmap": {
        "bitmap_pack_launch": ([_P, _I, _I, _P, _P], _I),
        "bitmap_unpack_launch": ([_P, _I, _I, _I, _P, _P], _I),
        "bitmap_error_string": ([_I], ctypes.c_char_p),
    },
    "scatter_add": {
        "scatter_add_launch": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
                               _I),
        "scatter_add_zscratch": ([_I], _LL),
        "scatter_add_iscratch": ([_I, _I], _LL),
        "scatter_add_resident_blocks": ([_I, _I, _P, _P], _I),
        "scatter_add_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_fwd": {
        "flash_fwd_launch": ([_P] * 5 + [_I] * 11 + [_P], _I),
        "flash_fwd_error_string": ([_I], ctypes.c_char_p),
    },
    "ssd_fwd": {
        "ssd_fwd_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
        "ssd_fwd_smem_bytes": ([_I, _I, _I], _I),
        "ssd_fwd_gscratch": ([_I, _I, _I], _LL),
        "ssd_fwd_error_string": ([_I], ctypes.c_char_p),
    },
}
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in RECOMPUTE_CALLS:
        RECOMPUTE_CALLS[k] = 0


def path_kernels(fused_encode: bool = True, fused_commit: bool = True,
                 use_hash_bitmap: bool = True) -> tuple[str, ...]:
    """The kernels one Zen sync launches on a route (``path_launches``
    says how often)."""
    enc = ("zen_encode",) if fused_encode else ("hash_stage", "row_compact")
    if fused_commit:
        com = ("zen_commit_push",) + (
            ("zen_commit_pull",) if use_hash_bitmap else ())
    else:
        com = ("coo_scatter_add",) + (
            ("bitmap_pack", "bitmap_unpack") if use_hash_bitmap else ())
    return enc + com


def path_launches(n: int, fused_encode: bool = True, fused_commit: bool = True,
                  use_hash_bitmap: bool = True) -> dict[str, int]:
    """Launches of each kernel in one Zen sync of ``n`` ranks on a route:
    one per worker (encode, pull decode) or server (commit push,
    scatter-add), except ``bitmap_pack``, which packs all n server masks
    in one launch."""
    return {k: 1 if k == "bitmap_pack" else n
            for k in path_kernels(fused_encode, fused_commit, use_hash_bitmap)}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_repro_typed", False):
        for fn, (args, res) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = args, res
        lib._repro_typed = True
    return lib


def _check(lib, src: str, rc: int, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{src}_error_string")(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _plain(t: torch.Tensor) -> bool:
    """A tensor on the CPU (or another host device) takes the plain
    version; a CUDA tensor the kernel and a meta one its output shapes."""
    return not (t.is_cuda or t.is_meta)


def _need(t: torch.Tensor, dtype, ndim: int, what: str) -> None:
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {ndim}-D {dtype} tensor, got "
            f"{t.dtype} shape {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(*ts: torch.Tensor) -> None:
    """float4 loads: every base pointer must be 16-byte aligned."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("kernel input is not 16-byte aligned (a view "
                             "with a storage offset?); pass .clone()")


def _kept_scratch(table: dict, dev: torch.device, stream: int, nz: int,
                  ns: int, *extra) -> list:
    """A kernel's scratch for ``stream``, kept across calls so no call
    zeroes memory: ``[zeroed, plain, *extra]``, a part of ``nz`` int32 that
    the kernel leaves zero and one of ``ns`` int32 that it overwrites, each
    grown when needed; ``extra`` seeds the entry's further state.  Hold the
    table's lock."""
    st = table.setdefault((dev.index, stream), [None, None, *extra])
    if st[0] is None or st[0].numel() < nz:
        st[0] = torch.zeros((nz,), dtype=torch.int32, device=dev)
    if st[1] is None or st[1].numel() < ns:
        st[1] = torch.empty((ns,), dtype=torch.int32, device=dev)
    return st


# The encode's scratch, per (device, stream): its 64-bit tally of finished
# blocks and their overflows (2 ints, left zero), the candidate lists that
# do not fit in shared memory and, for rows too wide for it, the rows and
# ballots.  The lock covers a call's use of it.
_ENCODE_SCRATCH: dict[tuple[int, int], list] = {}
_ENCODE_LOCK = threading.Lock()


@functools.cache
def _encode_sizes(C: int, n: int, r1: int, r2: int) -> tuple[int, int]:
    """The encode's shared-memory bytes and its list scratch (ints)."""
    lib = _lib("zen_encode")
    return (lib.zen_encode_smem_bytes(C, r1, r2),
            max(1, lib.zen_encode_gscratch(C, r1, r2, n)))


@_opaque("zen_encode")
def zen_encode_fused_op(indices: torch.Tensor, seeds: Sequence[int], n: int,
                        r1: int, r2: int):
    """Zen encode: indices int32 [C] (unique, EMPTY-padded) -> (pidx int32
    [n, r1+r2], occ int32 words [n, ceil((r1+r2)/32)], overflow int32).
    Rows too wide for shared memory (an EF-compressed bucket's) run from
    the kept global scratch."""
    if _plain(indices):
        PLAIN_CALLS["zen_encode"] += 1
        return ref.zen_encode_ref(indices, seeds, n, r1, r2)
    _need(indices, torch.int32, 1, "zen_encode indices")
    seeds = [int(s) & 0xFFFFFFFF for s in seeds]
    C, L = indices.shape[0], r1 + r2
    dev = indices.device
    pidx = torch.empty((n, L), dtype=torch.int32, device=dev)
    occ = torch.empty((n, -(-L // BITS)), dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.int32, device=dev)
    if indices.is_meta:
        return pidx, occ, ovf
    lib = _lib("zen_encode")
    _, ng = _encode_sizes(C, n, r1, r2)
    sd = (ctypes.c_uint * len(seeds))(*seeds)
    stream = _stream(indices)
    with _ENCODE_LOCK:
        st = _kept_scratch(_ENCODE_SCRATCH, dev, stream, 2, ng)
        rc = lib.zen_encode_launch(
            indices.data_ptr(), C, ctypes.cast(sd, _P), len(seeds), n, r1,
            r2, pidx.data_ptr(), occ.data_ptr(), ovf.data_ptr(),
            st[0].data_ptr(), st[1].data_ptr(), stream)
        _check(lib, "zen_encode", rc, "zen_encode launch")
    LAUNCHES["zen_encode"] += 1
    return pidx, occ, ovf


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def zen_fused_wide(n: int, cap_index: int, r1: int, r2: int,
                   cap_server: int) -> dict[str, bool]:
    """Which fused Zen kernels take their wide path at a layout's sizes
    (the encode's rows, the push's bitmap prefix or the pull's row scan
    out of shared memory); needs a card."""
    W = -(-cap_server // BITS)
    enc, com = _lib("zen_encode"), _lib("zen_commit")
    return {"zen_encode": bool(enc.zen_encode_wide(cap_index, r1, r2)),
            "zen_commit_push": bool(com.zen_commit_push_wide(cap_server)),
            "zen_commit_pull": com.zen_commit_pull_iscratch(n, W) > 0}


# The push's scratch, per (device, stream): the zeroed part and the slot
# tables as the scatter-add keeps them, the number of calls so far (its
# parity picks the touched-count word) and the staging rows, bytes of
# min(C, cap_server) x d values.  The lock covers a call's use of it.
_PUSH_SCRATCH: dict[tuple[int, int], list] = {}
_PUSH_LOCK = threading.Lock()


def _push_scratch(lib, dev: torch.device, stream: int, C: int, d: int,
                  el: int, cap_server: int) -> list:
    """The push's kept scratch for ``stream``, grown to this call's need.
    Hold ``_PUSH_LOCK``."""
    st = _kept_scratch(_PUSH_SCRATCH, dev, stream,
                       lib.zen_commit_push_zscratch(cap_server),
                       lib.zen_commit_push_iscratch(C, cap_server), 0, None)
    nstage = max(1, min(C, cap_server) * d * el)
    if st[3] is None or st[3].numel() < nstage:
        st[3] = torch.empty((nstage,), dtype=torch.uint8, device=dev)
    return st


def zen_commit_push_grid(lp: torch.Tensor, vals: torch.Tensor, *,
                         cap_server: int, cap_pull: int) -> tuple[int, int]:
    """(blocks of 256 threads, kept scratch bytes) of the push on a CUDA
    ``lp``/``vals``: its cooperative grid and the scratch it keeps for the
    current stream after a call of these sizes."""
    lib = _lib("zen_commit")
    v2 = vals[:, None] if vals.ndim == 1 else vals
    (C, d), dev = v2.shape, lp.device
    with _PUSH_LOCK:
        st = _push_scratch(lib, dev, _stream(lp), C, d, v2.element_size(),
                           cap_server)
        # out, a fresh allocation, is 16-byte aligned: vals stands in for it
        grid = lib.zen_commit_push_grid(
            _DTYPE_CODE[v2.dtype], C, d, cap_server, cap_pull, v2.data_ptr(),
            v2.data_ptr(), st[3].data_ptr())
        kept = sum(t.numel() * t.element_size() for t in (st[0], st[1], st[3]))
    return grid, kept


@_opaque("zen_commit_push")
def zen_commit_push_fused_op(lp: torch.Tensor, vals: torch.Tensor, *,
                             cap_server: int, cap_pull: int):
    """Zen commit push: lp int32 [C] server-local positions (EMPTY and
    >= cap_server dropped), vals [C(, d)] -> (lpos int32 [cap_pull], vals
    [cap_pull(, d)], bm int32 words [ceil(cap_server/32)], overflow).
    Past 376,832 slots (an EF-compressed bucket's server) the bitmap's
    prefix is scanned grid-wide in global scratch."""
    if _plain(lp):
        PLAIN_CALLS["zen_commit_push"] += 1
        return ref.zen_commit_push_ref(lp, vals, cap_server, cap_pull)
    squeeze = vals.ndim == 1
    v2 = vals[:, None] if squeeze else vals
    _need(lp, torch.int32, 1, "zen_commit_push lp")
    if v2.dtype not in _DTYPE_CODE:
        raise ValueError(f"zen_commit_push: values must be float32 or "
                         f"bfloat16, got {v2.dtype}")
    _need(v2, v2.dtype, 2, "zen_commit_push vals")
    if v2.device != lp.device or v2.shape[0] != lp.shape[0]:
        raise ValueError("zen_commit_push: lp and vals must share device "
                         "and row count")
    C, d = v2.shape
    dev = lp.device
    lpos = torch.empty((cap_pull,), dtype=torch.int32, device=dev)
    out = torch.empty((cap_pull, d), dtype=v2.dtype, device=dev)
    bm = torch.empty((-(-cap_server // BITS),), dtype=torch.int32, device=dev)
    ovf = torch.empty((1,), dtype=torch.int32, device=dev)
    if lp.is_meta:
        return lpos, (out[:, 0] if squeeze else out), bm, ovf[0]
    lib = _lib("zen_commit")
    stream = _stream(lp)
    with _PUSH_LOCK:
        st = _push_scratch(lib, dev, stream, C, d, v2.element_size(),
                           cap_server)
        rc = lib.zen_commit_push_launch(
            lp.data_ptr(), v2.data_ptr(), C, d, _DTYPE_CODE[v2.dtype],
            cap_server, cap_pull, lpos.data_ptr(), out.data_ptr(),
            bm.data_ptr(), ovf.data_ptr(), st[0].data_ptr(), st[1].data_ptr(),
            st[3].data_ptr(), st[2] & 1, stream)
        _check(lib, "zen_commit", rc, "zen_commit_push launch")
        st[2] += 1
    LAUNCHES["zen_commit_push"] += 1
    return lpos, (out[:, 0] if squeeze else out), bm, ovf[0]


# The pull's scratch, per (device, stream): its grid barrier's zeroed
# words and, for wide rows, the items' totals.  The lock covers a call's
# use of it.
_PULL_SCRATCH: dict[tuple[int, int], list] = {}
_PULL_LOCK = threading.Lock()


@_opaque("zen_commit_pull")
def zen_commit_pull_fused_op(words: torch.Tensor, cap_server: int,
                             cap_pull: int) -> torch.Tensor:
    """Zen pull decode: int32 words [n, W] -> int32 [n, cap_pull], each
    row's set-bit positions below ``cap_server``, ascending, EMPTY-padded.
    Rows wider than SMs / n x 1024 words (an EF-compressed bucket's) run
    as one cooperative launch with a grid barrier."""
    if _plain(words):
        PLAIN_CALLS["zen_commit_pull"] += 1
        return ref.zen_commit_pull_ref(words, cap_server, cap_pull)
    _need(words, torch.int32, 2, "zen_commit_pull words")
    n, W = words.shape
    dev = words.device
    lpos = torch.empty((n, cap_pull), dtype=torch.int32, device=dev)
    if words.is_meta:
        return lpos
    lib = _lib("zen_commit")
    stream = _stream(words)
    ni = lib.zen_commit_pull_iscratch(n, W)
    if ni < 0:
        raise RuntimeError("zen_commit_pull: no current CUDA device")
    with _PULL_LOCK:
        st = _kept_scratch(_PULL_SCRATCH, dev, stream,
                           lib.zen_commit_pull_zscratch(), max(1, ni))
        rc = lib.zen_commit_pull_launch(
            words.data_ptr(), n, W, cap_server, cap_pull, lpos.data_ptr(),
            st[0].data_ptr(), st[1].data_ptr(), stream)
        _check(lib, "zen_commit", rc, "zen_commit_pull launch")
    LAUNCHES["zen_commit_pull"] += 1
    return lpos


# ---------------------------------------------------------------------------
# The pre-fusion chain's kernels
# ---------------------------------------------------------------------------

@_opaque("hash_stage")
def hash_stage_op(indices: torch.Tensor, seeds: Sequence[int], n: int,
                  r1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1's hash stage: indices int32 [C] (EMPTY-padded) -> (p int32
    [C], q int32 [k, C]) with k = len(seeds) - 1; EMPTY maps to (n, r1)."""
    if _plain(indices):
        PLAIN_CALLS["hash_stage"] += 1
        return ref.hash_stage_ref(indices, seeds, n, r1)
    _need(indices, torch.int32, 1, "hash_stage indices")
    seeds = [int(s) & 0xFFFFFFFF for s in seeds]
    C, k = indices.shape[0], len(seeds) - 1
    p = torch.empty((C,), dtype=torch.int32, device=indices.device)
    q = torch.empty((k, C), dtype=torch.int32, device=indices.device)
    if C == 0 or indices.is_meta:
        return p, q
    lib = _lib("hash_stage")
    sd = (ctypes.c_uint * len(seeds))(*seeds)
    rc = lib.hash_stage_launch(indices.data_ptr(), C, ctypes.cast(sd, _P),
                               len(seeds), n, r1, p.data_ptr(), q.data_ptr(),
                               _stream(indices))
    _check(lib, "hash_stage", rc, "hash_stage launch")
    LAUNCHES["hash_stage"] += 1
    return p, q


@_opaque("row_compact")
def row_compact_op(mem: torch.Tensor) -> torch.Tensor:
    """int32 [R, L] -> [R, L]: each row's live (non-EMPTY) entries to the
    front in slot order, EMPTY-padded tail."""
    if _plain(mem):
        PLAIN_CALLS["row_compact"] += 1
        return ref.row_compact_ref(mem)
    _need(mem, torch.int32, 2, "row_compact mem")
    R, L = mem.shape
    out = torch.empty_like(mem)
    if out.numel() == 0 or mem.is_meta:
        return out
    lib = _lib("row_compact")
    rc = lib.row_compact_launch(mem.data_ptr(), R, L, out.data_ptr(),
                                _stream(mem))
    _check(lib, "row_compact", rc, "row_compact launch")
    LAUNCHES["row_compact"] += 1
    return out


@_opaque("bitmap_pack")
def bitmap_pack_rows_op(mask: torch.Tensor) -> torch.Tensor:
    """bool [n, L] -> int32 words [n, ceil(L/32)]: each row packed LSB
    first (the reference's uint32 bits), bits past L zero; one launch."""
    if _plain(mask):
        PLAIN_CALLS["bitmap_pack"] += 1
        return ref.bitmap_pack_rows_ref(mask)
    _need(mask, torch.bool, 2, "bitmap_pack mask")
    n, L = mask.shape
    words = torch.empty((n, -(-L // BITS)), dtype=torch.int32,
                        device=mask.device)
    if words.numel() == 0 or mask.is_meta:
        return words
    lib = _lib("bitmap")
    rc = lib.bitmap_pack_launch(mask.data_ptr(), n, L, words.data_ptr(),
                                _stream(mask))
    _check(lib, "bitmap", rc, "bitmap_pack launch")
    LAUNCHES["bitmap_pack"] += 1
    return words


@_opaque("bitmap_pack")
def bitmap_pack_op(mask: torch.Tensor) -> torch.Tensor:
    """bool [M] -> int32 words [ceil(M/32)]: ``bitmap_pack_rows_op`` of one
    row."""
    if mask.ndim != 1:
        raise ValueError(f"bitmap_pack: need a 1-D mask, got shape "
                         f"{tuple(mask.shape)}")
    return bitmap_pack_rows_op(mask[None])[0]


@_opaque("bitmap_unpack")
def bitmap_unpack_rows_op(words: torch.Tensor, length: int) -> torch.Tensor:
    """int32 words [n, W] -> bool [n, length], length <= 32 W: bit j of row
    r is bit (j mod 32) of ``words[r, j // 32]``; one launch."""
    if words.ndim != 2 or not 0 <= length <= words.shape[1] * BITS:
        raise ValueError(f"bitmap_unpack: need words [n, W] and 0 <= length "
                         f"<= 32 W, got shape {tuple(words.shape)} and "
                         f"length {length}")
    if _plain(words):
        PLAIN_CALLS["bitmap_unpack"] += 1
        return ref.bitmap_unpack_rows_ref(words, length)
    _need(words, torch.int32, 2, "bitmap_unpack words")
    n, W = words.shape
    bits = torch.empty((n, length), dtype=torch.bool, device=words.device)
    if bits.numel() == 0 or words.is_meta:
        return bits
    lib = _lib("bitmap")
    rc = lib.bitmap_unpack_launch(words.data_ptr(), n, W, length,
                                  bits.data_ptr(), _stream(words))
    _check(lib, "bitmap", rc, "bitmap_unpack launch")
    LAUNCHES["bitmap_unpack"] += 1
    return bits


@_opaque("bitmap_unpack")
def bitmap_unpack_op(words: torch.Tensor, length: int) -> torch.Tensor:
    """int32 words [W] -> bool [length]: ``bitmap_unpack_rows_op`` of one
    row."""
    if words.ndim != 1:
        raise ValueError(f"bitmap_unpack: need 1-D words, got shape "
                         f"{tuple(words.shape)}")
    return bitmap_unpack_rows_op(words[None], length)[0]


# The scatter-add's scratch, per (device, stream): a zeroed part that the
# kernel leaves zero, a part it overwrites (each grows when needed), and
# the number of calls so far, whose parity picks the word the kernel counts
# the touched targets in.
# The lock covers a call's use of it, from lookup to the parity's bump.
_SCATTER_SCRATCH: dict[tuple[int, int], list] = {}
_SCATTER_LOCK = threading.Lock()


@_opaque("coo_scatter_add")
def coo_scatter_add_op(out: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += vals[i]`` IN PLACE, and returns ``out`` [M, d].

    EMPTY, negative and >= M indices are dropped; duplicates accumulate in
    stream order, in the values' dtype (one rounding per add), starting
    from ``out``'s row.  Only touched rows of ``out`` are read and written.
    ``out`` and ``vals`` share a dtype (float32 or bfloat16)."""
    if _plain(out):
        PLAIN_CALLS["coo_scatter_add"] += 1
        return out.copy_(ref.coo_scatter_add_ref(out, idx, vals))
    _need(idx, torch.int32, 1, "coo_scatter_add idx")
    if out.dtype not in _DTYPE_CODE or vals.dtype != out.dtype:
        raise ValueError(f"coo_scatter_add: out and vals must share a dtype "
                         f"of float32 or bfloat16, got {out.dtype} and "
                         f"{vals.dtype}")
    _need(out, out.dtype, 2, "coo_scatter_add out")
    _need(vals, vals.dtype, 2, "coo_scatter_add vals")
    if not (vals.device == idx.device == out.device) \
            or vals.shape != (idx.shape[0], out.shape[1]):
        raise ValueError(f"coo_scatter_add: need idx [C], vals [C, d] and "
                         f"out [M, d] on one device, got {tuple(idx.shape)}, "
                         f"{tuple(vals.shape)}, {tuple(out.shape)}")
    (M, d), C = out.shape, idx.shape[0]
    if C == 0 or M == 0 or out.is_meta:
        return out
    lib = _lib("scatter_add")
    stream = _stream(out)
    with _SCATTER_LOCK:
        st = _kept_scratch(_SCATTER_SCRATCH, out.device, stream,
                           lib.scatter_add_zscratch(M),
                           lib.scatter_add_iscratch(C, M), 0)
        rc = lib.scatter_add_launch(idx.data_ptr(), vals.data_ptr(), C, d,
                                    _DTYPE_CODE[out.dtype], M, out.data_ptr(),
                                    st[0].data_ptr(), st[1].data_ptr(),
                                    st[2] & 1, stream)
        _check(lib, "scatter_add", rc, "coo_scatter_add launch")
        st[2] += 1
    LAUNCHES["coo_scatter_add"] += 1
    return out


@_opaque("coo_scatter_add")
def batched_coo_reduce_op(out: torch.Tensor, idx: torch.Tensor,
                          vals: torch.Tensor, *,
                          backend: str = "torch") -> torch.Tensor:
    """The flattened segment-reduce every scheme's server aggregation
    shares: COO segments ``idx [..]`` / ``vals [.., (d)]`` of any leading
    shape scatter-added into ``out [M(, d)]``, which is updated IN PLACE
    and returned.  EMPTY and out-of-range indices are dropped.
    ``backend="cuda"`` runs the scatter-add kernel (its plain version for a
    CPU tensor), ``"torch"`` the plain version.  Its callers: the unfused
    Zen commit, agsparse's reduce, sparcml's add into the running sum,
    the sparse_ps / balanced servers and pull decodes, and omnireduce's
    block adds (rows of width ``block * d``); duplicates add in stream
    order on both routes, which ``index_add_``'s CUDA atomics would not."""
    check_backend(backend)
    idx = idx.reshape(-1).contiguous()
    out2 = out[:, None] if out.ndim == 1 else out
    vals2 = vals.reshape(idx.shape[0], out2.shape[1]).contiguous()
    if backend == "cuda":
        coo_scatter_add_op(out2, idx, vals2)
    else:
        out2.copy_(ref.coo_scatter_add_ref(out2, idx, vals2))
    return out


def zen_encode_unfused(indices: torch.Tensor, seeds: Sequence[int], n: int,
                       r1: int, r2: int):
    """The pre-fusion encode chain: hash-stage kernel + plain insertion
    rounds + row-compaction kernel + pack kernel; the same outputs as
    ``zen_encode_fused_op``."""
    part = hierarchical_hash(indices, n=n, r1=r1, r2=r2, k=len(seeds) - 1,
                             seeds=seeds, backend="cuda")
    pidx = row_compact_op(part.memory)
    return pidx, bitmap_pack_rows_op(pidx != EMPTY), part.overflow


def zen_commit_push_unfused(lp: torch.Tensor, vals: torch.Tensor, *,
                            cap_server: int, cap_pull: int):
    """The pre-fusion commit push: scatter-add kernel + plain compaction
    and gather + pack kernel; the same outputs as
    ``zen_commit_push_fused_op``."""
    squeeze = vals.ndim == 1
    v2 = vals[:, None] if squeeze else vals
    buf = coo_scatter_add_op(
        torch.zeros((cap_server, v2.shape[-1]), dtype=v2.dtype,
                    device=v2.device), lp, v2.contiguous())
    mask = (buf != 0).any(dim=-1)
    lpos, overflow = compact_indices(mask, cap_pull)
    dead = lpos == EMPTY
    out = buf[torch.where(dead, 0, lpos).to(torch.int64)]
    out = torch.where(dead[:, None], torch.zeros_like(out), out)
    return lpos, (out[:, 0] if squeeze else out), bitmap_pack_op(mask), overflow


def zen_commit_pull_unfused(words: torch.Tensor, cap_server: int,
                            cap_pull: int) -> torch.Tensor:
    """The pre-fusion pull decode: unpack kernel straight into [n,
    cap_server] + plain row compaction; the same output as
    ``zen_commit_pull_fused_op``."""
    return compact_rows(bitmap_unpack_rows_op(words, cap_server), cap_pull)[0]


# ---------------------------------------------------------------------------
# The models' prefill kernels
# ---------------------------------------------------------------------------

FLASH_HEAD_DIMS = (32, 64, 128, 160)
# (q/k head dim, v head dim) pairs the kernel takes: k = v at each of
# FLASH_HEAD_DIMS, and MLA's q/k of 96 (64 + rope 32) with v of 64
FLASH_HEAD_PAIRS = tuple((hd, hd) for hd in FLASH_HEAD_DIMS) + ((96, 64),)


@_opaque("flash_fwd")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, q_offset: int = 0,
                 return_lse: bool = False, chunk: int = 512,
                 q_chunk: int = 1024):
    """GQA attention with an online softmax in f32: q [B, Sq, H, hd], k
    [B, Sk, KV, hd], v [B, Sk, KV, hd_v] -> [B, Sq, H, hd_v] in q's dtype
    (``ref.flash_fwd_ref`` says which keys each query row keeps); with
    ``return_lse`` also each row's log-sum-exp of its scaled scores [B,
    Sq, H] f32 (+inf where a row keeps no key), the backward's input.
    The kernel takes bfloat16 (on the tensor cores) or float32 (on the
    FMA units), (hd, hd_v) in ``FLASH_HEAD_PAIRS`` and H / KV <= 128; any
    other pair raises ``ValueError``.  ``chunk`` / ``q_chunk`` are the
    plain version's blocks (the kernel tiles by its own)."""
    if _plain(q):
        PLAIN_CALLS["flash_fwd"] += 1
        return ref.flash_fwd_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=chunk,
                                 q_chunk=q_chunk, return_lse=return_lse)
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _need(t, q.dtype, 4, f"flash_fwd {what}")
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if not (q.device == k.device == v.device) \
            or v.shape[:3] != k.shape[:3] or k.shape[0] != B \
            or k.shape[3] != hd or KV == 0 or H % KV or H // KV > 128 \
            or (hd, hd_v) not in FLASH_HEAD_PAIRS:
        raise ValueError(f"flash_fwd: need q [B, Sq, H, hd], k [B, Sk, KV, "
                         f"hd] and v [B, Sk, KV, hd_v] on one device, H % KV "
                         f"== 0, H / KV <= 128, hd in {FLASH_HEAD_DIMS} with "
                         f"hd_v = hd or (hd, hd_v) = (96, 64); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    out = q.new_empty((B, Sq, H, hd_v))
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or q.is_meta:
        return (out, lse) if return_lse else out
    _aligned(q, k, v)
    lib = _lib("flash_fwd")
    rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(),
                              lse.data_ptr() if return_lse else None,
                              B, Sq, Sk, H, KV, hd, hd_v,
                              _DTYPE_CODE[q.dtype], int(causal), int(window),
                              int(q_offset), _stream(q))
    _check(lib, "flash_fwd", rc, "flash_fwd launch")
    LAUNCHES["flash_fwd"] += 1
    return (out, lse) if return_lse else out


class FlashAttn(torch.autograd.Function):
    """``flash_fwd_op`` under autograd: (q, k, v) -> o, the attention of
    every trainer (``layers.flash_attention`` with grad enabled).

    The forward is ``flash_fwd_op(..., return_lse=True)``: the kernel for
    CUDA tensors, the plain version for CPU ones (``plain=True``, the
    ``"torch"`` route: ``ref.flash_fwd_ref`` on any device).  It keeps (q,
    k, v, o, lse), O(S) a row, never the S x S scores.  The backward is
    ``ref.flash_bwd_ref``, blockwise from lse: the reference
    differentiates its ``flash_attention`` by autodiff and has no backward
    kernel.  Each backward adds one to ``RECOMPUTE_CALLS["flash_fwd"]``.
    Where q's dtype differs from k/v's (whisper's cross-attention in
    training: a bf16 q on f32 K/V) q is promoted to their common dtype
    (the f32 kernel) and the output and dq cast back: the reference's
    ``flash_attention`` runs all three in f32 and returns q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int,
                chunk: int, q_chunk: int, plain: bool):
        dt = q.dtype
        ct = torch.promote_types(dt, k.dtype)
        q, k, v = (t.to(ct).contiguous() for t in (q, k, v))
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  chunk=chunk, q_chunk=q_chunk, return_lse=True)
        o, lse = (ref.flash_fwd_ref(q, k, v, **kw) if plain
                  else flash_fwd_op(q, k, v, **kw))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.dt = kw, dt
        return o.to(dt)

    @staticmethod
    def backward(ctx, do):
        RECOMPUTE_CALLS["flash_fwd"] += 1
        kw = {k: v for k, v in ctx.kw.items() if k != "return_lse"}
        dq, dk, dv = ref.flash_bwd_ref(*ctx.saved_tensors, do, **kw)
        return dq.to(ctx.dt), dk, dv, None, None, None, None, None, None


SSD_HEAD_DIMS = (32, 64)
SSD_STATE_DIMS = (16, 32, 64, 128)
SSD_MAX_CHUNK = 64


@_opaque("ssd_fwd")
def ssd_fwd_op(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, *, chunk: int = 64):
    """The Mamba2 SSD chunk scan (``ref.ssd_fwd_ref``): x [Bt, S, H, hd],
    dA [Bt, S, H], Bm/Cm [Bt, S, N], all float32, S a multiple of
    Q = min(chunk, S) -> (y [Bt, S, H, hd], state [Bt, H, hd, N]).  The
    kernel takes hd in ``SSD_HEAD_DIMS``, N in ``SSD_STATE_DIMS`` and
    Q <= ``SSD_MAX_CHUNK``."""
    if _plain(x):
        PLAIN_CALLS["ssd_fwd"] += 1
        return ref.ssd_fwd_ref(x, dA, Bm, Cm, chunk=chunk)
    _need(x, torch.float32, 4, "ssd_fwd x")
    _need(dA, torch.float32, 3, "ssd_fwd dA")
    _need(Bm, torch.float32, 3, "ssd_fwd Bm")
    _need(Cm, torch.float32, 3, "ssd_fwd Cm")
    Bt, S, H, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if not (x.device == dA.device == Bm.device == Cm.device) \
            or dA.shape != (Bt, S, H) or Bm.shape != (Bt, S, N) \
            or Cm.shape != Bm.shape or Q <= 0 or S % Q \
            or Q > SSD_MAX_CHUNK or hd not in SSD_HEAD_DIMS \
            or N not in SSD_STATE_DIMS:
        raise ValueError(f"ssd_fwd: need x [Bt, S, H, hd], dA [Bt, S, H], "
                         f"B = C [Bt, S, N] on one device with S % Q == 0, "
                         f"0 < Q <= {SSD_MAX_CHUNK}, hd in {SSD_HEAD_DIMS} "
                         f"and N in {SSD_STATE_DIMS}; got {tuple(x.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}, Q={Q}")
    if x.is_meta:
        # the shared-memory check below needs the library; within the
        # domain the scan takes at most 107,776 B (hd 64, N 128, Q 64)
        return (torch.empty_like(x), x.new_empty((Bt, H, hd, N)))
    lib = _lib("ssd_fwd")
    smem = lib.ssd_fwd_smem_bytes(hd, N, Q)
    if smem > _MAX_SMEM:
        raise ValueError(f"ssd_fwd: hd={hd}, N={N}, Q={Q} need {smem} B of "
                         f"shared memory (> {_MAX_SMEM})")
    y = torch.empty_like(x)
    state = torch.empty((Bt, H, hd, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    _aligned(x, dA, Bm, Cm)
    cbt = torch.empty((lib.ssd_fwd_gscratch(Bt, S, Q),), dtype=torch.float32,
                      device=x.device)
    rc = lib.ssd_fwd_launch(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
                            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                            cbt.data_ptr(), Bt, S, H, hd, N, Q, _stream(x))
    _check(lib, "ssd_fwd", rc, "ssd_fwd launch")
    LAUNCHES["ssd_fwd"] += 1
    return y, state


class SSDScan(torch.autograd.Function):
    """``ssd_fwd_op`` under autograd: (x, dA, Bm, Cm) -> (y, state).

    The forward is ``ssd_fwd_op`` (the kernel for CUDA tensors, the plain
    version for CPU ones) and keeps its four inputs.  The backward
    recomputes the plain scan ``ref.ssd_fwd_ref`` on them and returns its
    autograd gradients, exactly the plain version's: the reference trains
    Mamba2 by autodiff through its plain chunked scan and has no backward
    kernel.  Each backward adds one to ``RECOMPUTE_CALLS["ssd_fwd"]``."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dA, Bm, Cm)
        ctx.chunk = chunk
        return ssd_fwd_op(x, dA, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        RECOMPUTE_CALLS["ssd_fwd"] += 1
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ref.ssd_fwd_ref(*ins, chunk=ctx.chunk)
        outs = [(o, g) for o, g in ((y, gy), (state, gstate))
                if g is not None]   # None: that output took no gradient
        grads = torch.autograd.grad([o for o, _ in outs],
                                    ins, [g for _, g in outs],
                                    allow_unused=True)   # state skips Cm
        return (*grads, None)


# ---------------------------------------------------------------------------
# What a call costs, from its shapes
# ---------------------------------------------------------------------------

def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_pairs(Sq: int, Sk: int, causal: bool, window: int,
                 q_offset: int) -> int:
    """The (query, key) pairs ``flash_fwd_ref`` keeps for one head of one
    sequence: key j for the query at position p = q_offset + i where
    j <= p (causal) and j > p - window (window > 0)."""
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(Sk - 1, pos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def kernel_cost(name: str, args: tuple, kwargs: dict, outs) -> dict:
    """One wrapper call's cost from its shapes, under the bound convention
    of the kernel table (``PERF.md`` §6): ``flops``, the operations it
    does (the floating adds of the scatter-adds, the hash stage's integer
    hashing, the attention's and the scan's products; 0 for the integer
    compaction, packing and decoding), and ``bytes``, each input read once
    and each output written once (the scatter-add reads and writes at most
    C rows of ``out``).  ``fusable_bytes`` is what the plain version would
    write and read besides: ``flash_fwd``'s f32 scores.  Every row counts
    as live: the data is not looked at, so a meta call and a card call of
    one shape cost the same."""
    ins = [t for t in tree_flatten((args, kwargs))[0]
           if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_flatten(outs)[0] if isinstance(t, torch.Tensor)]
    io = _nbytes(ins) + _nbytes(outs)
    flops = fusable = 0
    if name == "coo_scatter_add":   # (out, idx, vals): out updated in place
        out, idx, vals = ins[:3]
        M = out.shape[0]
        d = out.numel() // max(M, 1)
        C = idx.numel()
        io = _nbytes([idx, vals]) + 2 * min(C, M) * d * out.element_size()
        flops = C * d
    elif name == "zen_commit_push":
        flops = ins[1].numel()                      # C x d adds
    elif name == "hash_stage":
        seeds = args[1] if len(args) > 1 else kwargs["seeds"]
        flops = ins[0].numel() * len(seeds) * 19   # hash_stage's ops a row
    elif name == "flash_fwd":
        q, k, v = ins[:3]
        B, Sq, H, hd = q.shape
        pairs = B * H * _flash_pairs(
            Sq, k.shape[1], kwargs.get("causal", True),
            kwargs.get("window", 0), kwargs.get("q_offset", 0))
        flops = 2 * pairs * (hd + v.shape[-1])
        fusable = 2 * 4 * B * H * Sq * k.shape[1]
    elif name == "ssd_fwd":
        x, _, Bm = ins[:3]
        Bt, S, H, hd = x.shape
        N = Bm.shape[-1]
        Q = min(args[4] if len(args) > 4 else kwargs.get("chunk", 64), S)
        tri = Q * (Q + 1) // 2
        flops = (Bt * (S // Q)
                 * (2 * tri * N + H * (2 * tri * hd + 4 * Q * N * hd)))
    return {"flops": flops, "bytes": io, "fusable_bytes": fusable}
