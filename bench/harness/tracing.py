"""The traced steps of a ``--trace 1`` run, and their reduction to what the
per-layer metric readers read.

The harness records from its own files (the program has no spans yet):

* ``bench.step`` around each traced step;
* spans around the program's calls that a runner names (a training cell:
  GradSync's ``__call__`` as ``bench.sync``, ``FlashAttn``'s backward as
  ``bench.attn_bwd``), put in place for the traced steps only;
* :class:`CallRecorder`, the port's kernel-wrapper hook (``ops.TRACE``):
  each wrapper call's name and the shapes and bytes of its tensors, from
  which the yardstick counts the call's work.

:func:`profile` runs the steps under ``torch.profiler`` and returns the
record: the device's busy seconds (the union of every device operation's
interval), the traced window's wall seconds, device seconds by kernel
name, device seconds under each span, the recorded calls, and the
longest idle gaps named by the host operation running when they opened.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the port's sentinel of an index slot that holds nothing (its index
# formats' EMPTY): the Zen kernels' work depends on how many slots are live
EMPTY = 2**31 - 1


def _live(t: torch.Tensor, below: int | None = None) -> torch.Tensor:
    """A device count of the slots of ``t`` that hold an index (below
    ``below``), launched on the current stream, read after the steps."""
    ok = t != EMPTY
    if below is not None:
        ok &= (t >= 0) & (t < below)
    return ok.sum()


class CallRecorder:
    """The ``ops.TRACE`` hook: runs each wrapper call and keeps its name
    and the bytes its inputs need: a ``flash_fwd`` call's shapes and mask
    (every input read once, every output written once); a Zen call's
    reads and writes of live slots and rows only, counted on the device
    beside the call (``finish`` reads the counts):

    * ``zen_encode``: the live indices read, the live partition slots and
      the occupancy words written;
    * ``zen_commit_push``: every position read, the rows of the live ones
      read, the live server slots' positions and rows and the bitmap
      written;
    * ``zen_commit_pull``: every bitmap word read, the live positions
      written."""

    def __init__(self):
        self.calls: list[dict] = []

    def kernel(self, name, fn, args, kwargs):
        out = fn(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        call = {"name": name, "in_bytes": _nbytes(ins),
                "out_bytes": _nbytes(outs)}
        if name == "flash_fwd":
            q, k, v = ins[:3]
            call.update(q=tuple(q.shape), k=tuple(k.shape),
                        v=tuple(v.shape),
                        dtype=str(q.dtype).removeprefix("torch."),
                        causal=bool(kwargs.get("causal", True)),
                        window=int(kwargs.get("window", 0)),
                        q_offset=int(kwargs.get("q_offset", 0)))
        elif name == "zen_encode":
            idx, (pidx, occ, ovf) = ins[0], outs[:3]
            call.update(in_bytes=(_live(idx), 4),
                        out_bytes=(_live(pidx), 4, _nbytes([occ, ovf])))
        elif name == "zen_commit_push":
            lp, vals = ins[:2]
            lpos, _, bm, ovf = outs[:4]
            row = vals.element_size() * (vals[0].numel() if vals.ndim > 1
                                         else 1)
            cap = kwargs.get("cap_server")
            call.update(in_bytes=(_live(lp, cap), row, lp.nbytes),
                        out_bytes=(_live(lpos), 4 + row, _nbytes([bm, ovf])))
        elif name == "zen_commit_pull":
            call.update(in_bytes=ins[0].nbytes,
                        out_bytes=(_live(outs[0]), 4, 0))
        self.calls.append(call)
        return out

    def finish(self) -> list[dict]:
        """The calls with every count read: ``in_bytes`` and ``out_bytes``
        as numbers."""
        for c in self.calls:
            for key in ("in_bytes", "out_bytes"):
                if isinstance(c[key], tuple):
                    n, per, fixed = (*c[key], 0)[:3]
                    c[key] = int(n) * per + fixed
        return self.calls


@contextlib.contextmanager
def spans(targets: dict):
    """Wrap each ``(owner, attribute)`` of ``targets`` ({span name: (owner,
    attribute, is_static)}) in ``record_function(span name)`` for the
    block, then put the originals back."""
    from torch.profiler import record_function

    saved = []

    def wrap(fn, name):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    for name, (owner, attr, static) in targets.items():
        orig = owner.__dict__[attr]
        fn = orig.__func__ if static else orig
        saved.append((owner, attr, orig))
        setattr(owner, attr,
                staticmethod(wrap(fn, name)) if static else wrap(fn, name))
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(step, steps: int, span_names) -> dict:
    """Run ``step(i)`` for i < ``steps`` under ``torch.profiler`` (CPU and
    CUDA), each in a ``bench.step`` span, and reduce the trace."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            with record_function("bench.step"):
                step(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(),
                  set(span_names) | {"bench.step"}, window_s)


def reduce(events, names, window_s: float) -> dict:
    """The record of a trace's raw events (``_KinetoEvent``s, read
    directly: building the profiler's event tree takes minutes at these
    sizes).  A device operation belongs to a span when the host operation
    that launched it (its linked correlation id) started inside the span
    on the same thread."""
    from torch.autograd import DeviceType

    ops = {}           # correlation id -> (thread, start) of a host op
    spans = {n: {} for n in names}   # name -> thread -> [(start, end)]
    host = []          # (start, end, name) of every host op
    device = []        # (start, end, name, linked correlation id)
    for e in events:
        hidden = getattr(e, "is_hidden_event", None)
        if hidden is not None and hidden():
            continue
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:   # a torch op or a span
                ops[e.correlation_id()] = (e.start_thread_id(), start)
                host.append((start, end, name))
                if name in spans:
                    spans[name].setdefault(e.start_thread_id(), []).append(
                        (start, end))
        elif not e.is_user_annotation() and name not in names:
            device.append((start, end, name, e.linked_correlation_id()))
    for by_thread in spans.values():
        for iv in by_thread.values():
            iv.sort()
    span_s = dict.fromkeys(names, 0.0)
    by_name: dict[str, float] = {}
    for start, end, name, corr in device:
        dur = (end - start) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + dur
        op = ops.get(corr)
        if op is None:
            continue
        thread, at = op
        for span, by_thread in spans.items():
            iv = by_thread.get(thread)
            if iv:
                k = bisect.bisect_right(iv, (at, float("inf"))) - 1
                if k >= 0 and iv[k][0] <= at < iv[k][1]:
                    span_s[span] += dur
    busy = _merge([(s, t) for s, t, _, _ in device])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:10]
    idle = []
    for length, at in gaps:
        cover = [h for h in host if h[0] <= at < h[1]]
        # the innermost host operation: the last to start of those running
        idle.append([max(cover)[2] if cover else "host", length * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(t - s for s, t in busy) * 1e-9,
            "window_s": window_s, "kernels": by_name, "spans": span_s,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": idle}}
