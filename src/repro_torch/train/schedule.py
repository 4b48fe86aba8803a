"""Per-bucket sync pipeline (port of ``repro.train.schedule.run_schedule``).

Encode, then commit, bucket by bucket, in order.  The reference fences
bucket i+1's encode against bucket i's commit so XLA can overlap them; the
port's overlap (encode on a compute stream while the commit's collective
runs on a comm stream) is ROADMAP queue 1, item 5.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

from repro_torch.core.buckets import Bucket
from repro_torch.core.schemes import SyncStats


def run_schedule(
    buckets: Sequence[Bucket],
    payloads: Sequence[Any],
    encode: Callable[[Bucket, Any], Any],
    commit: Callable[[Bucket, Any], tuple[Any, SyncStats]],
) -> tuple[list[Any], list[SyncStats]]:
    """(synced payloads, per-bucket SyncStats), both in bucket order."""
    outs, stats = [], []
    for b, p in zip(buckets, payloads):
        out, st = commit(b, encode(b, p))
        outs.append(out)
        stats.append(st)
    return outs, stats
