"""Error-feedback gradient sparsification (port of ``repro.core.sparsify``).

Dense gradient buckets are sparsified before the sync, so Zen runs on
every dense bucket as an element-sparse payload of the bucket's size:

* **Sparsifiers**: ``topk`` keeps exactly ``keep_count(S)`` elements of
  largest ``|acc|``, ties at the k-th value going to the lowest indices as
  ``lax.top_k`` picks them; ``threshold`` keeps ``|acc| >= tau``;
  ``randk`` keeps a Bernoulli(density) mask.
* **Error feedback**: the residual ``r`` (f32, one per compressed bucket
  and rank, optimizer state) is added back before compressing: ``acc =
  g + r``, ``sent = S(acc)``, ``r' = acc - sent``, with ``sent`` cast to
  the payload's dtype before the subtraction, so ``sent + r' == g + r``
  exactly in f32.

randk's mask stream is the port's own: ``torch.rand`` from a
``torch.Generator`` on the payload's device seeded with
:func:`randk_seed` of ``(cfg.seed, bucket id, step)``.  The reference
draws it with threefry (``jax.random``), so the two masks differ; every
local rank of a bucket draws the same mask, as every rank does under the
reference's ``vmap``.  The reference's ``compress_profile``,
``measured_profile`` and ``DensityController`` (the ``auto`` scheme's
feedback loop) are not ported (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import math

import torch

KINDS = ("none", "topk", "threshold", "randk")
DENSITY1_KEY = "sync/ef_density1[{key}]"
DENSITYN_KEY = "sync/ef_densityN[{key}]"


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """How dense gradient buckets are sparsified before synchronization."""

    kind: str = "none"        # none | topk | threshold | randk
    # topk/randk: fraction of elements kept; for threshold the capacity
    # budget the sparse buffers are provisioned for
    density: float = 0.01
    threshold: float = 0.0    # threshold kind: keep |g| >= threshold
    ef: bool = True           # error-feedback residual memory
    seed: int = 0             # randk mask stream

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"compress kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind in ("topk", "randk") and not 0 < self.density <= 1:
            raise ValueError(
                f"compress density must be in (0, 1], got {self.density}")

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    def tag(self) -> str:
        """Round-trippable spec string (the bucket plan's compress tag)."""
        if not self.enabled:
            return "none"
        arg = self.threshold if self.kind == "threshold" else self.density
        return f"{self.kind}:{arg:g}" + ("" if self.ef else ":noef")

    def keep_count(self, size: int) -> int:
        """Static per-bucket capacity in elements (k for top-k; the
        provisioning budget for threshold/randk)."""
        return max(1, min(size, int(math.ceil(size * self.density))))


def parse_compress(spec) -> CompressConfig:
    """Parse ``--compress`` specs: ``topk:0.01``, ``randk:0.05``,
    ``threshold:1e-3``, with an optional ``:noef`` suffix (EF off), or
    ``none``.  A CompressConfig passes through unchanged."""
    if isinstance(spec, CompressConfig):
        return spec
    if spec is None:
        return CompressConfig()
    parts = str(spec).split(":")
    kind = parts[0] or "none"
    if kind == "none":
        return CompressConfig()
    ef = True
    if parts[-1] == "noef":
        ef = False
        parts = parts[:-1]
    if len(parts) != 2:
        raise ValueError(
            f"compress spec must look like 'topk:0.01[:noef]', got {spec!r}")
    val = float(parts[1])
    if kind == "threshold":
        return CompressConfig(kind=kind, threshold=val, ef=ef)
    return CompressConfig(kind=kind, density=val, ef=ef)


def randk_seed(seed: int, bucket: int, step: int) -> int:
    """The randk generator's seed for one bucket at one step: a fixed
    mixing of ``(seed, bucket id, step)`` into 63 bits."""
    h = 0
    for v in (seed, bucket, step):
        h = ((h ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) * 0x9E3779B97F4A7C15) \
            & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


def _topk_mask(a: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest elements of ``a`` [S] (no NaN), ties at the k-th
    value taken in index order: everything above the k-th value, then the
    first tied elements that fill k."""
    kth = torch.topk(a, k, sorted=False).values.min()
    above = a > kth
    tied = a == kth
    room = k - above.sum(dtype=torch.int32)
    return above | (tied & (torch.cumsum(tied, 0, dtype=torch.int32) <= room))


def _keep_mask(cfg: CompressConfig, acc: torch.Tensor,
               seed: int | None) -> torch.Tensor:
    """Boolean keep-mask over the f32 accumulator ``acc`` [S]."""
    if cfg.kind == "topk":
        return _topk_mask(acc.abs(), cfg.keep_count(acc.shape[0]))
    if cfg.kind == "threshold":
        return acc.abs() >= cfg.threshold
    if cfg.kind == "randk":
        if seed is None:
            raise ValueError("randk needs its generator seed (randk_seed)")
        gen = torch.Generator(device=acc.device).manual_seed(seed)
        return torch.rand(acc.shape, generator=gen, dtype=torch.float32,
                          device=acc.device) < cfg.density
    raise ValueError(f"not a sparsifier: {cfg.kind!r}")


def compress_bucket(cfg: CompressConfig, payload: torch.Tensor,
                    residual: torch.Tensor | None, *,
                    seed: int | None = None):
    """EF-compress one rank's flat bucket payload ``[S]`` (any float dtype).

    ``residual``: f32 [S] error-feedback memory, or None when ``cfg.ef`` is
    off.  ``seed``: randk's generator seed (:func:`randk_seed`).

    Returns ``(sent, new_residual, density)``: the sparsified payload in
    the input dtype (zeros off the mask), the updated residual (None iff
    ``residual`` is None) and the f32 local density d(1) = nnz / S.  EF
    invariant: ``sent.float() + new_residual == payload.float() + residual``
    exactly in f32."""
    acc = payload.float()
    if residual is not None:
        acc = acc + residual
    mask = _keep_mask(cfg, acc, seed)
    sent = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype,
                                              device=acc.device))
    sent = sent.to(payload.dtype)
    new_residual = None
    if residual is not None:
        new_residual = acc - sent.float()
    return sent, new_residual, density(mask)


def density(mask: torch.Tensor) -> torch.Tensor:
    """f32 share of True along the last dim, as the reference's f32 mean of
    a 0/1 mask: the count times the f32 reciprocal of the length."""
    count = mask.sum(-1, dtype=torch.int32).float()
    one = torch.ones((), dtype=torch.float32, device=mask.device)
    return count * (one / float(mask.shape[-1]))
