"""Op-trace cost walker: FLOPs, bytes, collective wire bytes and peak
memory of one eager step (the port's counterpart of
``repro.launch.hlo_cost``; its HLO walker becomes a walk of the aten op
stream, as ``hlo_ir`` became ``analysis/trace_ir``).

:class:`CostMode` is a ``TorchDispatchMode``: run one step under it (on
the card, on the CPU, or on the meta device over a fake world,
``launch/dryrun.py``) and it keeps one :class:`CostRecord` an op, with
the step's live and peak bytes.  :func:`analyze` folds the records as the
reference folds its HLO, with the reference's heuristics:

  * FLOPs: the matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``convolution`` and its backward) count ``2 |result| contraction``;
    every other op counts ``|result|``, an in-place one too; a view, or
    an op whose results alias its inputs without writing, counts nothing.
  * HBM bytes: twice the result bytes of every op whose result is a new
    buffer (written once, read about once); a view, or an op that writes
    into an input (``copy_``, ``add_``, a collective's output), makes no
    new buffer and costs nothing.  Operand sizes are not summed.
  * Kernel records: a wrapper of ``kernels/ops.py`` is one opaque
    ``kernel:<name>`` record (``ops.TRACE``) with its shape-based cost,
    ``ops.kernel_cost``: each input read once, each output written once;
    ``flash_fwd`` also carries the f32 score bytes its plain version would
    materialize (``fusable_bytes``), which ``analyze(exclude=...)`` drops.
  * Collective bytes: every ``c10d`` op is one collective, its kind under
    the reference's names, its group size read from its ProcessGroup, and
    its per-device wire bytes ``WIRE_FACTOR[kind](g)`` times its data
    bytes: the result one rank holds (an all-gather's whole output); a
    c10d op the port's groups never call raises.

The reference needs trip counts because its step is a ``lax.scan`` that
XLA's cost analysis counts once; an eager step runs every layer, so the
op stream already holds each of them and nothing is multiplied.  A layer
recomputed in the backward (``torch.utils.checkpoint``, the reference's
remat) runs its forward ops a second time inside the backward, and they
are walked there; so are ``FlashAttn``'s blockwise backward ops.

Peak memory: the mode counts, by storage, the bytes of every new buffer
made under it while it is alive (``weakref`` on the storage); ``peak`` is
the most live at once: the recompute keeps a layer's activations alive
only from its recompute to its backward, as the step without the mode
does.  Buffers made before the step (the parameters,
the optimizer state, the batch) are the caller's argument bytes.  A
kernel wrapper's scratch kept on the card is not seen.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
import weakref
from typing import Iterable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.trace_ir import WIRE_FACTOR
from repro_torch.kernels import ops

# c10d op -> the reference's collective kind: the ops the port's groups
# call (``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single``)
COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "alltoall_base_": "all-to-all"}
MATMULS = ("mm", "bmm", "addmm", "baddbmm")
# a Python number made a 0-d tensor: where eager does so depends on the
# device (the CPU wraps it, meta and CUDA make it), so it is not counted
HOST_SCALARS = ("scalar_tensor",)
CONVOLUTIONS = ("convolution", "_convolution")
# the records whose FLOPs are products (``matmul_flops``): what PyTorch's
# ``FlopCounterMode`` counts of the port's steps, the reference's dots
PRODUCTS = frozenset(f"aten.{n}" for n in (*MATMULS, *CONVOLUTIONS,
                                            "convolution_backward"))


@dataclasses.dataclass
class CostRecord:
    """One op of a traced step: an aten op, a kernel wrapper call
    (``kernel:<name>``) or a collective (``kind`` set)."""

    op: str
    flops: float = 0.0
    bytes: float = 0.0
    fusable_bytes: float = 0.0
    kind: str | None = None          # a collective's WIRE_FACTOR key
    group_size: int = 0
    data_bytes: float = 0.0

    @property
    def wire_bytes(self) -> float:
        return WIRE_FACTOR[self.kind](self.group_size) * self.data_bytes


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult


@functools.cache
def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (a
    decomposition into other aten ops)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    """2 |result| contraction of a matmul-like op."""
    a = args[0] if name in ("mm", "bmm") else args[1]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(args, out: torch.Tensor) -> float:
    """A forward convolution: 2 |result| (C_in / groups) prod(kernel)."""
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


def _conv_backward_flops(args) -> float:
    """``convolution_backward``: the forward's count for each of the input
    and weight gradients it makes."""
    grad_out, w, mask = args[0], args[2], args[-1]
    fwd = 2.0 * grad_out.numel() * math.prod(w.shape[1:])
    return fwd * sum(bool(m) for m in mask[:2])


def _group_size(func, args, kwargs) -> int:
    for arg, val in zip(func._schema.arguments,
                        list(args) + [kwargs.get(a.name) for a in
                                      func._schema.arguments[len(args):]]):
        if arg.name == "process_group" and val is not None:
            return dist.ProcessGroup.unbox(val).size()
    raise ValueError(f"{func}: no process group among its arguments")


def _collective(func, args, kwargs) -> CostRecord:
    """The record of one c10d op: its kind, group size and data bytes
    (the result this rank holds)."""
    name = func._schema.name.split("::")[-1]
    if name not in COLLECTIVES:
        raise ValueError(f"trace_cost: no collective kind for c10d op "
                         f"{name!r}")
    kind = COLLECTIVES[name]
    # the first argument holds the outputs (the reduced tensors in place)
    data = sum(_nbytes(t) for t in _tensors(args[0]))
    if name == "alltoall_base_" and len(args) > 4 and args[3] \
            and sum(1 for n in args[3] if n) == 1 \
            and sum(1 for n in args[4] if n) == 1:
        # an alltoallv with one peer's share each way: a permute
        # (DistGroup.ppermute)
        kind = "collective-permute"
    return CostRecord(op=f"c10d.{name}", kind=kind,
                      group_size=_group_size(func, args, kwargs),
                      data_bytes=float(data))


class CostMode(TorchDispatchMode):
    """Record the cost of every op run under it (``with CostMode() as cm:
    step(...)``), the kernel wrappers' calls as opaque records
    (``ops.TRACE``), and the step's live and peak bytes of new buffers."""

    def __init__(self):
        super().__init__()
        self.records: list[CostRecord] = []
        self.live = 0
        self.peak = 0
        self._quiet = 0
        self._depth = 0       # the mode re-enters itself to decompose
        self._seen: weakref.WeakSet = weakref.WeakSet()
        self._counted: dict[int, weakref.finalize] = {}   # by storage id
        self._zeros = None    # the storage the last op, a new_zeros, made

    def __enter__(self):
        if ops.TRACE is not None and ops.TRACE is not self:
            raise RuntimeError("an op trace is already recording")
        self._depth += 1
        ops.TRACE = self
        try:
            return super().__enter__()
        except BaseException:
            self._exit_trace()
            raise

    def _exit_trace(self) -> None:
        self._depth -= 1
        if not self._depth:
            ops.TRACE = None

    def __exit__(self, *exc):
        self._exit_trace()
        return super().__exit__(*exc)

    # -- live bytes ------------------------------------------------------------
    def _free(self, n: int, key: int) -> None:
        self.live -= n
        self._counted.pop(key, None)

    def _count(self, st, n: int) -> None:
        """Count ``n`` bytes live until storage ``st`` dies."""
        self._seen.add(st)
        self._counted[id(st)] = weakref.finalize(st, self._free, n, id(st))

    def _new_buffers(self, ins: list, outs: list) -> list[torch.Tensor]:
        """The outputs whose storage no input shares (new buffers), each
        counted live until its storage dies."""
        have = {id(t.untyped_storage()) for t in ins}
        new = []
        for t in outs:
            st = t.untyped_storage()
            if id(st) in have or st in self._seen:
                continue
            have.add(id(st))
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._count(st, n)
            new.append(t)
        return new

    def _in_place(self, src, dst) -> None:
        """Move the count of storage ``src`` to ``dst``, which takes its
        place: the buffer an op outside the mode would have written in
        place."""
        _, _, (n, _), _ = self._counted.pop(id(src)).detach()
        self._count(dst, n)

    # -- recording -------------------------------------------------------------
    def kernel(self, name: str, fn, args, kwargs):
        """One kernel wrapper call: run it without logging its inner ops,
        log one record with ``ops.kernel_cost``."""
        if self._quiet:
            return fn(*args, **kwargs)
        self._quiet += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._quiet -= 1
        cost = ops.kernel_cost(name, args, kwargs, out)
        self._new_buffers(_tensors((args, kwargs)), _tensors(out))
        self.records.append(CostRecord(
            op=f"kernel:{name}", flops=float(cost["flops"]),
            bytes=float(cost["bytes"]),
            fusable_bytes=float(cost["fusable_bytes"])))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        # a composite op reaches the mode whole where autograd is off
        # (inference mode): walk its decomposition, the ops autograd sees
        if _composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        zeros, self._zeros = self._zeros, None
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self.records.append(_collective(func, args, kwargs))
            return out
        name = func.overloadpacket.__name__
        if name in HOST_SCALARS:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name == "scatter_add" and zeros is not None \
                and zeros() is args[0].untyped_storage():
            # ATen's gather backward: a zero buffer and a scatter_add into
            # it, out of place under a dispatch mode (this one) and in
            # place without; counted as the step without the mode runs it
            self._in_place(args[0].untyped_storage(), out.untyped_storage())
            self.records.append(CostRecord(op="aten.scatter_add_",
                                           flops=float(out.numel())))
            return out
        new = self._new_buffers(ins, outs)
        if name == "new_zeros":
            self._zeros = weakref.ref(out.untyped_storage())
        if func.is_view or (outs and not new
                            and not func._schema.is_mutable):
            return out           # a view, or an alias (``_unsafe_view``)
        if name in MATMULS:
            flops = _matmul_flops(name, args, outs[0])
        elif name in CONVOLUTIONS:
            flops = _conv_flops(args, outs[0])
        elif name == "convolution_backward":
            flops = _conv_backward_flops(args)
        else:
            flops = float(sum(t.numel() for t in outs))
        self.records.append(CostRecord(
            op=str(func.overloadpacket), flops=flops,
            bytes=2.0 * sum(_nbytes(t) for t in new)))
        return out


def analyze(records: Iterable[CostRecord] | CostMode,
            exclude: str | None = None) -> dict:
    """Fold the records: ``{"flops", "bytes", "collectives": {kind: wire
    bytes}, "collective_bytes_total"}``.  ``exclude`` (a regex) drops the
    bytes a kernel would keep on chip where it matches ``"flash_fusable"``
    (``--fused-attn``, the reference's ``exclude_bytes_re``)."""
    fused = bool(exclude and re.search(exclude, "flash_fusable"))
    total = Cost()
    for r in getattr(records, "records", records):
        if r.kind is not None:
            total.add(Cost(coll={r.kind: r.wire_bytes}))
        else:
            total.add(Cost(flops=r.flops, bytes=r.bytes + (
                0.0 if fused else r.fusable_bytes)))
    return {"flops": total.flops, "bytes": total.bytes,
            "collectives": dict(sorted(total.coll.items())),
            "collective_bytes_total": sum(total.coll.values())}


def matmul_flops(records: Iterable[CostRecord] | CostMode) -> float:
    """The FLOPs of the products (``PRODUCTS``: matmuls, convolutions and
    their backwards) among the records, a kernel wrapper's calls left
    out as ``FlopCounterMode`` leaves them out."""
    return sum(r.flops for r in getattr(records, "records", records)
               if r.op in PRODUCTS)


def collective_wire(records: Iterable[CostRecord] | CostMode
                    ) -> dict[str, float]:
    """Per-device wire bytes keyed by ``"<kind>/<group size>"``, the key
    ``analysis/trace_ir.collective_wire`` uses, as a JSON-ready key."""
    out: dict[str, float] = {}
    for r in getattr(records, "records", records):
        if r.kind is not None:
            key = f"{r.kind}/{r.group_size}"
            out[key] = out.get(key, 0.0) + r.wire_bytes
    return dict(sorted(out.items()))
