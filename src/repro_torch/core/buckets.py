"""Gradient buckets (port of the flat-topology part of ``repro.core.buckets``).

A ``BucketPlan`` partitions the gradient leaves into fixed-byte
**buckets**, the unit at which GradSync emits sync ops
(``repro_torch.train.schedule``):

* **Dense leaves** are flattened and fused: consecutive leaves of one dtype
  are packed into one bucket while the bucket stays at or under
  ``bucket_bytes`` (a single leaf larger than the budget is its own
  oversized bucket; leaves are never split).  One psum per bucket replaces
  one psum per leaf; a psum is elementwise, so fusion changes no bit on the
  in-process group.
* **Row-sparse leaves** (Zen's subject) are never fused or split: each is
  its own bucket, since the Zen layout is a function of the whole table.
* ``bucket_bytes=None`` is the **monolithic fallback**: one bucket per leaf.

The plan is built offline from ``(name, shape, dtype)`` leaves; a step's
work is only ``gather_bucket`` / ``scatter_bucket`` (a concatenation and
slices) around each bucket's sync.  Payloads keep the port's leading
worker dimension: a dense bucket is ``[local, sum of sizes]``.  With a
compressor (``core/sparsify.py``) every dense bucket carries its tag in
``compress`` and is synced on its EF-sparsified payload (by Zen, an
element-sparse payload of the bucket's size, or by a psum); row-sparse
buckets are never compressed.  On a two-level topology a bucket's scheme
may be a plan tag such as ``hier(zen@intra,dense@inter)``
(``core/topology.py``), and the stats carry each level's words.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.schemes import SyncStats
from repro_torch.core.topology import parse_plan

DENSE = "dense_fused"
SPARSE = "sparse"


def _all_dense(tag: str) -> bool:
    """Whether a plan tag moves only psum traffic: the bare 'dense' tag, or
    a hier plan whose every stage is dense (its words belong in
    ``sync/dense_words`` at every node size)."""
    if tag == "dense":
        return True
    if tag.startswith("hier("):
        try:
            return all(s.scheme == "dense" for s in parse_plan(tag).stages)
        except ValueError:
            return False
    return False


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One gradient leaf's home inside a bucket payload."""

    name: str            # '/'-joined leaf path
    index: int           # position in the leaf list
    shape: tuple         # per-worker leaf shape
    dtype: torch.dtype
    offset: int          # element offset inside the fused payload
    size: int            # element count


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A unit of synchronization: one sync op per bucket."""

    bid: int
    kind: str                     # DENSE | SPARSE
    # the resolved CommPlan tag (core/topology.py): a bare scheme name, or
    # on a two-level topology under 'auto' a tag such as
    # 'hier(zen@intra,dense@inter)'
    scheme: str
    slots: tuple[LeafSlot, ...]   # exactly 1 slot when kind == SPARSE
    nbytes: int
    # compressor tag (core/sparsify.py spec, e.g. 'topk:0.01') of a dense
    # bucket whose payload is EF-sparsified before the sync, else 'none'
    compress: str = "none"

    @property
    def size(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def key(self) -> str:
        """Stable identity for per-bucket state (EF residuals, Zen
        layouts): the first slot's leaf path."""
        return self.slots[0].name


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Offline partition of the gradient leaves into sync buckets."""

    buckets: tuple[Bucket, ...]
    n_leaves: int
    bucket_bytes: int | None

    @property
    def schemes(self) -> tuple[str, ...]:
        return tuple(b.scheme for b in self.buckets)

    def validate(self) -> None:
        """Every leaf in exactly one bucket; sparse buckets are singletons;
        fused dense buckets respect the byte budget (oversized leaves may
        stand alone)."""
        seen: set[int] = set()
        for b in self.buckets:
            for s in b.slots:
                if s.index in seen:
                    raise ValueError(f"leaf {s.name} assigned twice")
                seen.add(s.index)
            if b.kind == SPARSE and len(b.slots) != 1:
                raise ValueError(f"sparse bucket {b.bid} fuses leaves")
            if b.kind == SPARSE and b.compress != "none":
                raise ValueError(
                    f"row-sparse bucket {b.bid} must not be compressed")
            if (self.bucket_bytes is not None and b.kind == DENSE
                    and len(b.slots) > 1 and b.nbytes > self.bucket_bytes):
                raise ValueError(f"fused bucket {b.bid} exceeds bucket_bytes")
        if len(seen) != self.n_leaves:
            raise ValueError(
                f"plan covers {len(seen)} of {self.n_leaves} leaves")


def make_bucket_plan(
    leaves: Sequence[tuple[str, tuple, torch.dtype]],
    is_sparse: Callable[[str], bool],
    bucket_bytes: int | None,
    sparse_scheme: Callable[[str, tuple], str],
    dense_scheme: str = "dense",
    compress: str = "none",
    compressed_scheme: Callable[[str, int], str] | None = None,
) -> BucketPlan:
    """Build the plan from ``(name, per-worker shape, dtype)`` leaves in
    gradient order; ``sparse_scheme(name, shape)`` resolves a row-sparse
    leaf's scheme, dense buckets use ``dense_scheme``, unless ``compress``
    is a sparsifier tag: then every dense bucket carries it and takes its
    scheme from ``compressed_scheme(key, size)``."""
    if bucket_bytes is not None and bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: list[Bucket] = []
    pend: list[LeafSlot] = []   # dense leaves awaiting fusion
    pend_bytes = 0

    def flush():
        nonlocal pend, pend_bytes
        if pend:
            scheme = dense_scheme
            if compress != "none" and compressed_scheme is not None:
                scheme = compressed_scheme(pend[0].name,
                                           sum(s.size for s in pend))
            buckets.append(Bucket(bid=len(buckets), kind=DENSE,
                                  scheme=scheme, slots=tuple(pend),
                                  nbytes=pend_bytes, compress=compress))
            pend, pend_bytes = [], 0

    for i, (name, shape, dtype) in enumerate(leaves):
        shape = tuple(shape)
        size = 1
        for s in shape:
            size *= s
        nbytes = size * dtype.itemsize
        if is_sparse(name):
            flush()
            buckets.append(Bucket(
                bid=len(buckets), kind=SPARSE,
                scheme=sparse_scheme(name, shape),
                slots=(LeafSlot(name, i, shape, dtype, 0, size),),
                nbytes=nbytes))
            continue
        fits = (bucket_bytes is not None and pend
                and pend[0].dtype == dtype
                and pend_bytes + nbytes <= bucket_bytes)
        if not fits:
            flush()
        pend.append(LeafSlot(name, i, shape, dtype,
                             offset=sum(s.size for s in pend), size=size))
        pend_bytes += nbytes
        if bucket_bytes is None or pend_bytes >= bucket_bytes:
            flush()
    flush()
    plan = BucketPlan(buckets=tuple(buckets), n_leaves=len(leaves),
                      bucket_bytes=bucket_bytes)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# payload assembly / disassembly
# ---------------------------------------------------------------------------

def gather_bucket(bucket: Bucket, flat_leaves: list) -> torch.Tensor:
    """A bucket's payload from the ``[local, ...]`` leaf stacks: a sparse
    bucket's leaf as it is (the scheme needs its [rows, d] structure), a
    dense bucket's leaves as ``[local, -1]`` concatenated on dim 1."""
    if bucket.kind == SPARSE:
        return flat_leaves[bucket.slots[0].index]
    parts = [flat_leaves[s.index] for s in bucket.slots]
    parts = [p.reshape(p.shape[0], -1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def scatter_bucket(bucket: Bucket, payload: torch.Tensor, out: list) -> None:
    """Write a synced payload back into the leaf list ``out``: each slot's
    columns as ``[local, *shape]``."""
    if bucket.kind == SPARSE:
        out[bucket.slots[0].index] = payload
        return
    local = payload.shape[0]
    for s in bucket.slots:
        out[s.index] = payload[:, s.offset:s.offset + s.size].reshape(
            local, *s.shape)


# ---------------------------------------------------------------------------
# SyncStats reduction across buckets
# ---------------------------------------------------------------------------

def reduce_stats(plan: BucketPlan, per_bucket: list[SyncStats],
                 extra: dict[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
    """Per-bucket SyncStats -> the trainer's per-worker metric vectors:
    ``sync/sparse_sent_words`` (sparse-scheme buckets, row-sparse leaves
    and compressed dense buckets alike), ``sync/overflow``,
    ``sync/dense_words`` (psum buckets), ``sync/n_buckets``,
    ``sync/compressed_buckets`` (when any is) and per-scheme bucket counts
    ``sync/buckets[<scheme>]``; on a two-level topology also each level's
    words, ``sync/intra_words`` and ``sync/inter_words``; ``extra``
    (per-bucket EF densities) is merged in."""
    like = per_bucket[0].sent_words
    zero = torch.zeros_like(like)
    sent, dense_words = zero, zero
    overflow = torch.zeros_like(per_bucket[0].overflow)
    tags: dict[str, int] = {}
    n_compressed = 0
    level_words: list = []
    for b, st in zip(plan.buckets, per_bucket):
        overflow = overflow + st.overflow
        if b.kind == SPARSE or not _all_dense(b.scheme):
            sent = sent + st.sent_words
        else:
            dense_words = dense_words + st.sent_words
        tags[b.scheme] = tags.get(b.scheme, 0) + 1
        n_compressed += b.compress != "none"
        # two-level plans tag their words by level (fastest first)
        for i, w in enumerate(st.by_level):
            if len(level_words) <= i:
                level_words.append(zero)
            level_words[i] = level_words[i] + w
    stats = {
        "sync/sparse_sent_words": sent,
        "sync/overflow": overflow,
        "sync/dense_words": dense_words,
        "sync/n_buckets": torch.full_like(like, float(len(plan.buckets))),
    }
    if len(level_words) >= 2:
        stats["sync/intra_words"] = level_words[0]
        stats["sync/inter_words"] = level_words[-1]
    if n_compressed:
        stats["sync/compressed_buckets"] = torch.full_like(
            like, float(n_compressed))
    for scheme, count in sorted(tags.items()):
        stats[f"sync/buckets[{scheme}]"] = torch.full_like(like, float(count))
    stats.update(extra or {})
    return stats
