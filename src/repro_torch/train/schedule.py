"""Double-buffered emission of per-bucket sync ops (port of
``repro.train.schedule``).

GradSync syncs bucket by bucket in a software pipeline, in the reference's
issue order:

    enc[0] = encode(bucket 0)
    for i in buckets:
        enc[i+1] = encode(bucket i+1)        # local compute
        out[i]   = commit(bucket i, enc[i])  # collective + decode-apply

``encode`` is a bucket's local, collective-free stage (Zen's compaction,
hash and extract; the payload's assembly for a dense bucket) and
``commit`` everything from the first collective on.  An optional
``compress`` stage (EF sparsification, ``core/sparsify.py``) runs just
before ``encode`` in the same pipeline slot.  The reference fences
``(enc[i], enc[i+1])`` with an ``optimization_barrier`` so XLA overlaps
bucket i's collective with bucket i+1's encode.  Here that fence is
stream order: on CUDA every encode runs on a side stream, which first
waits for the current stream's work, and records an event; ``commit(i)``
runs on the current stream after waiting for encode i's event.  So the
card runs encode(i+1) while commit(i)'s kernels and collectives run, and
the collectives stay on the stream that ``torch.distributed`` syncs with.
Tensors an encode makes on the side stream are marked as used by the
current stream, so the caching allocator reuses their memory only after
the commit that reads them (a compress hook's side outputs, such as the
EF residuals GradSync keeps, are its caller's to mark).  On the CPU the
same order runs without streams.  Neither changes a bit:
:func:`run_in_order` is the plain loop the pipeline must equal.

On a two-level topology an ``intra`` stage (the fast level's collectives)
runs bucket i's intra-node hop between encode i's event and commit(i),
after encode(i+1) has been issued on the side stream, so the cheap hop
overlaps the next encode as the slow commit does.  Like every collective
it runs on the current stream.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.core.buckets import Bucket
from repro_torch.core.schemes import SyncStats


def _tensors(tree: Any):
    """The tensors of a nest of tuples / lists (NamedTuples included)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def run_schedule(
    buckets: Sequence[Bucket],
    payloads: Sequence[Any],
    encode: Callable[[Bucket, Any], Any],
    commit: Callable[[Bucket, Any], tuple[Any, SyncStats]],
    stream: torch.cuda.Stream | None = None,
    compress: Callable[[Bucket, Any], Any] | None = None,
    intra: Callable[[Bucket, Any], Any] | None = None,
) -> tuple[list[Any], list[SyncStats]]:
    """Emit the double-buffered per-bucket sync pipeline; ``payloads[i]``
    is read in encode i's pipeline slot (on ``stream`` when given).

    ``stream``: the CUDA side stream for the encodes, or None (the CPU)
    to issue them in the same order on the current stream.  ``compress``:
    ``compress(bucket, payload) -> payload'``, run just before the
    bucket's encode in its slot.  ``intra``: ``intra(bucket, enc) ->
    enc'``, a two-level topology's fast-level stage, run on the current
    stream after encode(i+1) was issued and before commit(i).  Returns
    (synced payloads, per-bucket SyncStats), both in bucket order."""
    nb = len(buckets)
    outs: list[Any] = [None] * nb
    stats: list[SyncStats] = [None] * nb
    if nb == 0:
        return outs, stats
    main = None
    if stream is not None:
        main = torch.cuda.current_stream(stream.device)
        stream.wait_stream(main)

    def slot(i: int):
        p = payloads[i]
        if compress is not None:
            p = compress(buckets[i], p)
        return encode(buckets[i], p)

    def prefetch(i: int):
        if stream is None:
            return slot(i), None
        with torch.cuda.stream(stream):
            enc = slot(i)
            done = torch.cuda.Event()
            done.record(stream)
        return enc, done

    enc, done = prefetch(0)
    for i, b in enumerate(buckets):
        nxt = prefetch(i + 1) if i + 1 < nb else None
        if done is not None:
            main.wait_event(done)
            for t in _tensors(enc):
                t.record_stream(main)
        if intra is not None:
            enc = intra(b, enc)
        outs[i], stats[i] = commit(b, enc)
        if nxt is not None:
            enc, done = nxt
    return outs, stats


def run_in_order(
    buckets: Sequence[Bucket],
    payloads: Sequence[Any],
    encode: Callable[[Bucket, Any], Any],
    commit: Callable[[Bucket, Any], tuple[Any, SyncStats]],
    compress: Callable[[Bucket, Any], Any] | None = None,
    intra: Callable[[Bucket, Any], Any] | None = None,
) -> tuple[list[Any], list[SyncStats]]:
    """Compress (optional), encode, intra (optional), then commit, bucket
    by bucket on the current stream: the oracle :func:`run_schedule` must
    equal bit for bit."""
    outs, stats = [], []
    for b, p in zip(buckets, payloads):
        if compress is not None:
            p = compress(b, p)
        enc = encode(b, p)
        if intra is not None:
            enc = intra(b, enc)
        out, st = commit(b, enc)
        outs.append(out)
        stats.append(st)
    return outs, stats


def encode_all(
    buckets: Sequence[Bucket],
    payloads: Sequence[Any],
    encode: Callable[[Bucket, Any], Any],
    compress: Callable[[Bucket, Any], Any] | None = None,
) -> list[Any]:
    """The pipeline's local prefix in isolation: every bucket's compress
    (optional) and encode, no collectives, in order."""
    out = []
    for b, p in zip(buckets, payloads):
        if compress is not None:
            p = compress(b, p)
        out.append(encode(b, p))
    return out
