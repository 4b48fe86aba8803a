"""Wrappers around the Zen CUDA kernels, with their launch counters.

Port of the dispatch half of ``repro.kernels.ops``.  Each wrapper takes the
device from its tensors: a CUDA tensor launches the hand-written kernel
(``csrc/``) or raises; a CPU tensor takes the kernel's plain version in
``kernels/ref.py``.  There is no fallback from a failed launch.

``LAUNCHES[name]`` counts kernel launches and ``PLAIN_CALLS[name]`` counts
calls that took the plain version; ``reset_counts()`` zeroes both.  The
counters are plain integers so a run can show which route its path took.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

BITS = 32
KERNELS = ("zen_encode", "zen_commit_push", "zen_commit_pull")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "zen_encode": {
        "zen_encode_launch": ([_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
        "zen_encode_smem_bytes": ([_I, _I, _I], _I),
        "zen_encode_error_string": ([_I], ctypes.c_char_p),
    },
    "zen_commit": {
        "zen_commit_push_launch": (
            [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P], _I),
        "zen_commit_push_iscratch": ([_I, _I], _LL),
        "zen_commit_pull_launch": ([_P, _I, _I, _I, _I, _P, _P], _I),
        "zen_commit_error_string": ([_I], ctypes.c_char_p),
    },
}
_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


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


def _need(t: torch.Tensor, dtype, ndim: int, what: str) -> None:
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {ndim}-D {dtype} tensor, got "
            f"{t.dtype} shape {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def zen_encode_fused_op(indices: torch.Tensor, seeds: Sequence[int], n: int,
                        r1: int, r2: int):
    """Zen encode: indices int32 [C] (unique, EMPTY-padded) -> (pidx int32
    [n, r1+r2], occ int32 words [n, ceil((r1+r2)/32)], overflow int32)."""
    if not indices.is_cuda:
        PLAIN_CALLS["zen_encode"] += 1
        return ref.zen_encode_ref(indices, seeds, n, r1, r2)
    _need(indices, torch.int32, 1, "zen_encode indices")
    seeds = [int(s) & 0xFFFFFFFF for s in seeds]
    lib = _lib("zen_encode")
    C, L = indices.shape[0], r1 + r2
    smem = lib.zen_encode_smem_bytes(C, r1, r2)
    if smem > _MAX_SMEM:
        raise ValueError(f"zen_encode: row r1+r2={L} with C={C} needs "
                         f"{smem} B of shared memory (> {_MAX_SMEM})")
    dev = indices.device
    pidx = torch.empty((n, L), dtype=torch.int32, device=dev)
    occ = torch.empty((n, -(-L // BITS)), dtype=torch.int32, device=dev)
    ovf = torch.empty((n,), dtype=torch.int32, device=dev)
    sd = (ctypes.c_uint * len(seeds))(*seeds)
    rc = lib.zen_encode_launch(
        indices.data_ptr(), C, ctypes.cast(sd, _P), len(seeds), n, r1, r2,
        pidx.data_ptr(), occ.data_ptr(), ovf.data_ptr(), _stream(indices))
    _check(lib, "zen_encode", rc, "zen_encode launch")
    LAUNCHES["zen_encode"] += 1
    return pidx, occ, ovf.sum(dtype=torch.int32)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def zen_commit_push_fused_op(lp: torch.Tensor, vals: torch.Tensor, *,
                             cap_server: int, cap_pull: int):
    """Zen commit push: lp int32 [C] server-local positions (EMPTY and
    >= cap_server dropped), vals [C(, d)] -> (lpos int32 [cap_pull], vals
    [cap_pull(, d)], bm int32 words [ceil(cap_server/32)], overflow)."""
    if not lp.is_cuda:
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
    lib = _lib("zen_commit")
    C, d = v2.shape
    dev = lp.device
    lpos = torch.empty((cap_pull,), dtype=torch.int32, device=dev)
    out = torch.empty((cap_pull, d), dtype=v2.dtype, device=dev)
    bm = torch.empty((-(-cap_server // BITS),), dtype=torch.int32, device=dev)
    ovf = torch.empty((1,), dtype=torch.int32, device=dev)
    iscr = torch.empty((lib.zen_commit_push_iscratch(C, cap_server),),
                       dtype=torch.int32, device=dev)
    buf = torch.empty((cap_server, d), dtype=v2.dtype, device=dev)
    rc = lib.zen_commit_push_launch(
        lp.data_ptr(), v2.data_ptr(), C, d, _DTYPE_CODE[v2.dtype], cap_server,
        cap_pull, lpos.data_ptr(), out.data_ptr(), bm.data_ptr(),
        ovf.data_ptr(), iscr.data_ptr(), buf.data_ptr(), _stream(lp))
    _check(lib, "zen_commit", rc, "zen_commit_push launch")
    LAUNCHES["zen_commit_push"] += 1
    return lpos, (out[:, 0] if squeeze else out), bm, ovf[0]


def zen_commit_pull_fused_op(words: torch.Tensor, cap_server: int,
                             cap_pull: int) -> torch.Tensor:
    """Zen pull decode: int32 words [n, W] -> int32 [n, cap_pull], each
    row's set-bit positions below ``cap_server``, ascending, EMPTY-padded."""
    if not words.is_cuda:
        PLAIN_CALLS["zen_commit_pull"] += 1
        return ref.zen_commit_pull_ref(words, cap_server, cap_pull)
    _need(words, torch.int32, 2, "zen_commit_pull words")
    lib = _lib("zen_commit")
    n, W = words.shape
    lpos = torch.empty((n, cap_pull), dtype=torch.int32, device=words.device)
    rc = lib.zen_commit_pull_launch(words.data_ptr(), n, W, cap_server,
                                    cap_pull, lpos.data_ptr(), _stream(words))
    _check(lib, "zen_commit", rc, "zen_commit_pull launch")
    LAUNCHES["zen_commit_pull"] += 1
    return lpos
