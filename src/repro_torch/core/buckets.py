"""Gradient buckets (port of the monolithic plan of ``repro.core.buckets``).

Only ``bucket_bytes=None`` is ported: one bucket per leaf, leaves never
fused (ROADMAP queue 1, item 5 keeps the fused dense buckets).  A row-sparse
leaf is a SPARSE bucket synced with its sparse scheme; every other leaf is
a DENSE bucket synced with a psum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.schemes import SyncStats

DENSE = "dense_fused"
SPARSE = "sparse"


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One leaf and how it is synchronized."""

    bid: int
    kind: str          # DENSE | SPARSE
    scheme: str        # 'zen' | 'dense'
    name: str          # '/'-joined leaf path
    index: int         # position in the leaf list
    shape: tuple

    @property
    def key(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]


def make_bucket_plan(leaves: Sequence[tuple[str, tuple]],
                     is_sparse: Callable[[str], bool],
                     sparse_scheme: Callable[[str, tuple], str],
                     dense_scheme: str = "dense") -> BucketPlan:
    """One bucket per ``(name, shape)`` leaf, in leaf order."""
    buckets = []
    for i, (name, shape) in enumerate(leaves):
        sparse = is_sparse(name)
        buckets.append(Bucket(
            bid=i, kind=SPARSE if sparse else DENSE,
            scheme=sparse_scheme(name, shape) if sparse else dense_scheme,
            name=name, index=i, shape=tuple(shape)))
    return BucketPlan(buckets=tuple(buckets))


def gather_bucket(bucket: Bucket, flat_leaves: list) -> torch.Tensor:
    """A bucket's payload: its leaf (stacked over workers)."""
    return flat_leaves[bucket.index]


def scatter_bucket(bucket: Bucket, payload: torch.Tensor, out: list) -> None:
    out[bucket.index] = payload


def reduce_stats(plan: BucketPlan,
                 per_bucket: list[SyncStats]) -> dict[str, torch.Tensor]:
    """Per-bucket SyncStats -> the trainer's per-worker metric vectors:
    ``sync/sparse_sent_words`` (sparse-scheme buckets), ``sync/overflow``,
    ``sync/dense_words`` (psum buckets), ``sync/n_buckets`` and per-scheme
    bucket counts ``sync/buckets[<scheme>]``."""
    sent = dense_words = overflow = None
    tags: dict[str, int] = {}
    for b, st in zip(plan.buckets, per_bucket):
        overflow = st.overflow if overflow is None else overflow + st.overflow
        if b.kind == SPARSE or b.scheme != "dense":
            sent = st.sent_words if sent is None else sent + st.sent_words
        else:
            dense_words = (st.sent_words if dense_words is None
                           else dense_words + st.sent_words)
        tags[b.scheme] = tags.get(b.scheme, 0) + 1
    like = next(iter(per_bucket)).sent_words
    zero = torch.zeros_like(like)
    stats = {
        "sync/sparse_sent_words": zero if sent is None else sent,
        "sync/overflow": overflow,
        "sync/dense_words": zero if dense_words is None else dense_words,
        "sync/n_buckets": torch.full_like(like, float(len(plan.buckets))),
    }
    for scheme, count in sorted(tags.items()):
        stats[f"sync/buckets[{scheme}]"] = torch.full_like(like, float(count))
    return stats
