"""The traced program zenlint reads: a recording group and an op trace.

The port's counterpart of ``repro.analysis.hlo_ir``.  The reference lints
the HLO that XLA lowers a sync to; the port runs the sync once, eagerly,
and records what it did:

  * :class:`RecordingGroup` wraps a ``SimGroup`` or a ``DistGroup``
    (``core/schemes.py``) with the same interface.  Each ``all_to_all``,
    ``all_gather``, ``psum`` and ``ppermute`` is one
    :class:`CollectiveRecord`: its kind under the reference's names, the
    group size and the bytes of the result ONE worker receives, with the
    workers it ran for.  ``split`` and ``adopt_level`` hand back recorded
    sub-groups, so a two-level sync's levels are told apart by group
    size, as in the reference.  ``mean``, ``broadcast_`` and ``rank_ids``
    are the wrapped group's, unrecorded: none is a collective of a
    scheme's sync.
  * :class:`OpTrace`, a ``TorchDispatchMode``, logs every aten op of the
    sync as an :class:`OpRecord`: the op, its input and output dtypes,
    shapes and devices, the current CUDA stream, the pipeline phase it ran
    in, and whether an input derives from a collective's output (taint,
    carried from a collective's result through every op's outputs by
    tensor identity).  A kernel wrapper of ``kernels/ops.py`` is one
    opaque ``kernel:<name>`` record (``ops.TRACE``): the ops of its plain
    version are not the sync's own.  The collectives' internals are not
    traced either (gloo staging a CUDA tensor through host memory is the
    collective, not a host sync of the program), and any
    ``torch.cuda.set_sync_debug_mode`` is lifted while they run.

:func:`collective_wire` folds the records to per-worker wire bytes keyed
by ``(kind, group size)`` with the reference's ring weighting
(``WIRE_FACTOR``, applied to the result bytes as ``hlo_ir.wire_data_bytes``
counts them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

# the reference's dtype names of torch's dtypes (those this torch has)
DTYPE_NAMES = {getattr(torch, t): name for t, name in (
    ("float64", "f64"), ("float32", "f32"), ("bfloat16", "bf16"),
    ("float16", "f16"), ("int64", "s64"), ("uint64", "u64"),
    ("int32", "s32"), ("uint32", "u32"), ("int16", "s16"),
    ("uint16", "u16"), ("int8", "s8"), ("uint8", "u8"), ("bool", "pred"),
    ("float8_e4m3fn", "f8e4m3fn"), ("float8_e5m2", "f8e5m2"),
    ("complex64", "c64"), ("complex128", "c128")) if hasattr(torch, t)}
FLOAT_DTYPES = ("f64", "f32", "bf16", "f16", "f8e4m3fn", "f8e5m2")

# per-worker wire volume as a multiple of the op's result bytes, given
# the group size g (ring algorithms; the reference's hlo_ir.WIRE_FACTOR)
WIRE_FACTOR: dict[str, Callable[[int], float]] = {
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# the group methods that are collectives, by the reference's kind names
GROUP_COLLECTIVES = {"psum": "all-reduce", "all_gather": "all-gather",
                     "all_to_all": "all-to-all",
                     "ppermute": "collective-permute"}

# ops whose index arguments may hold a boolean mask (a data-dependent
# number of selected elements)
_INDEX_OPS = ("index", "index_put", "_index_put_impl", "_unsafe_index_put")
_COPY_OPS = ("_to_copy", "copy", "_copy_from", "_copy_from_and_resize")


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def base_name(op: str) -> str:
    """``aten.index_add_`` -> ``index_add``; a ``kernel:`` record as is."""
    if op.startswith("kernel:"):
        return op
    name = op.split(".")[-1]
    return name[:-1] if name.endswith("_") else name


@dataclasses.dataclass
class OpRecord:
    """One aten op (or one kernel wrapper call) of a traced sync."""

    op: str                      # "aten.sort", "kernel:zen_encode"
    in_dtypes: tuple[str, ...]
    in_shapes: tuple[tuple, ...]
    out_dtypes: tuple[str, ...]
    out_shapes: tuple[tuple, ...]
    in_devices: tuple[str, ...]
    out_devices: tuple[str, ...]
    stream: int | None           # current CUDA stream, on the card
    tainted: bool                # an input derives from a collective output
    phase: tuple | None = None   # ("encode", i) / ("commit", i) / None
    bool_index: bool = False     # an index argument is a boolean mask

    @property
    def name(self) -> str:
        return base_name(self.op)

    @property
    def device_to_host(self) -> bool:
        return (self.name in _COPY_OPS and "cuda" in self.in_devices
                and "cpu" in self.out_devices)


@dataclasses.dataclass
class CollectiveRecord:
    """One collective of a recorded group: ``nbytes`` is the result one
    worker receives (an all-gather: the whole gathered stack)."""

    kind: str                    # WIRE_FACTOR's keys
    group_size: int
    nbytes: int
    workers: tuple[int, ...]     # the global workers it ran for
    phase: tuple | None = None
    stream: int | None = None

    @property
    def wire_bytes(self) -> float:
        return WIRE_FACTOR[self.kind](self.group_size) * self.nbytes


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _current_stream(ts: Sequence[torch.Tensor]) -> int | None:
    for t in ts:
        if t.is_cuda:
            return torch.cuda.current_stream(t.device).cuda_stream
    return None


class OpTrace(TorchDispatchMode):
    """Log every aten op run under it (``with OpTrace() as tr: ...``) and
    take the kernel wrappers' calls as opaque records (``ops.TRACE``).

    ``records`` holds the :class:`OpRecord` s and, from the
    :class:`RecordingGroup` s given this trace, the
    :class:`CollectiveRecord` s, in issue order."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.current_phase: tuple | None = None
        self._taint: dict[int, weakref.ref] = {}
        self._quiet = 0      # > 0 inside a collective or a kernel wrapper

    # -- taint ---------------------------------------------------------------
    def tainted(self, t: torch.Tensor) -> bool:
        ref = self._taint.get(id(t))
        return ref is not None and ref() is t

    def taint(self, ts: Iterable[torch.Tensor]) -> None:
        for t in ts:
            self._taint[id(t)] = weakref.ref(t)

    # -- scopes ----------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, kind: str, index: int):
        """Tag the records made inside with ``(kind, index)``."""
        prev, self.current_phase = self.current_phase, (kind, index)
        try:
            yield
        finally:
            self.current_phase = prev

    @contextlib.contextmanager
    def quiet(self):
        """Run without logging (a collective's internals)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __enter__(self):
        if ops.TRACE is not None:
            raise RuntimeError("an OpTrace is already recording")
        ops.TRACE = self
        try:
            return super().__enter__()
        except BaseException:
            ops.TRACE = None
            raise

    def __exit__(self, *exc):
        ops.TRACE = None
        return super().__exit__(*exc)

    # -- recording -------------------------------------------------------------
    def _log(self, op: str, ins: list, outs: list, bool_index: bool = False):
        tainted = any(self.tainted(t) for t in ins)
        if tainted:
            self.taint(outs)
        self.records.append(OpRecord(
            op=op, in_dtypes=tuple(dtype_name(t.dtype) for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_dtypes=tuple(dtype_name(t.dtype) for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            in_devices=tuple(t.device.type for t in ins),
            out_devices=tuple(t.device.type for t in outs),
            stream=_current_stream(ins + outs), tainted=tainted,
            phase=self.current_phase, bool_index=bool_index))

    def kernel(self, name: str, fn, args, kwargs):
        """One kernel wrapper call: run it quietly, log one record."""
        if self._quiet:
            return fn(*args, **kwargs)
        stream = _current_stream(_tensors((args, kwargs)))
        with self.quiet():
            out = fn(*args, **kwargs)
        self._log(f"kernel:{name}", _tensors((args, kwargs)), _tensors(out))
        self.records[-1].stream = stream
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        op = str(func.overloadpacket)
        bool_index = False
        if base_name(op) in _INDEX_OPS and len(args) > 1:
            bool_index = any(t.dtype == torch.bool for t in _tensors(args[1]))
        self._log(op, _tensors((args, kwargs)), _tensors(out), bool_index)
        return out


@contextlib.contextmanager
def _no_sync_debug():
    """Lift ``torch.cuda.set_sync_debug_mode`` for a collective's run."""
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() \
        else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


class RecordingGroup:
    """``group`` (a ``SimGroup`` or ``DistGroup``) recording the
    collectives a sync runs on it, and on the sub-groups ``split`` hands
    out, into ``records`` (the ``trace``'s when one is given).

    ``workers`` are the global ids of the workers the group's stacks hold:
    all ``n`` of an in-process group, this rank alone of a distributed
    one."""

    def __init__(self, group, trace: OpTrace | None = None,
                 records: list | None = None,
                 workers: Sequence[int] | None = None):
        self.inner = group
        self.n = group.n
        self.ranks = group.ranks
        self.trace = trace
        self.records = (records if records is not None
                        else trace.records if trace is not None else [])
        self.workers = tuple(group.ranks if workers is None else workers)

    def __getattr__(self, name):   # mean, broadcast_, rank_ids, ...
        return getattr(self.inner, name)

    def split(self, sizes: Sequence[int], axis: int):
        return [(rows, RecordingGroup(sub, self.trace, self.records,
                                      [self.workers[r] for r in rows]))
                for rows, sub in self.inner.split(sizes, axis)]

    def adopt_level(self, sizes: Sequence[int], axis: int, group) -> None:
        self.inner.adopt_level(sizes, axis, getattr(group, "inner", group))

    def _run(self, method: str, x: torch.Tensor, *extra) -> torch.Tensor:
        quiet = self.trace.quiet() if self.trace is not None \
            else contextlib.nullcontext()
        with quiet, _no_sync_debug():
            out = getattr(self.inner, method)(x, *extra)
        kind = GROUP_COLLECTIVES[method]
        shape = out.shape if kind == "all-gather" else out.shape[1:]
        nbytes = math.prod(shape) * out.element_size()
        phase = stream = None
        if self.trace is not None:
            self.trace.taint([out])
            phase = self.trace.current_phase
            stream = _current_stream([out])
        self.records.append(CollectiveRecord(
            kind=kind, group_size=self.n, nbytes=nbytes,
            workers=self.workers, phase=phase, stream=stream))
        return out

    def all_to_all(self, x):
        return self._run("all_to_all", x)

    def all_gather(self, x):
        return self._run("all_gather", x)

    def psum(self, x):
        return self._run("psum", x)

    def ppermute(self, x, pairs):
        return self._run("ppermute", x, pairs)


def collective_wire(records) -> dict[tuple[str, int], float]:
    """Per-worker wire bytes keyed by ``(kind, group size)``: each worker's
    sum over the collectives it ran, the largest over the workers (every
    worker's, for a symmetric sync; a level group that ``level_sync`` ran
    once for several identical groups counts for the workers it ran
    for).  ``records``: a list, an :class:`OpTrace` or a
    :class:`RecordingGroup`."""
    per: dict[int, dict] = {}
    for r in getattr(records, "records", records):
        if not isinstance(r, CollectiveRecord):
            continue
        key = (r.kind, r.group_size)
        for w in r.workers:
            acc = per.setdefault(w, {})
            acc[key] = acc.get(key, 0.0) + r.wire_bytes
    out: dict[tuple[str, int], float] = {}
    for acc in per.values():
        for k, v in acc.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
