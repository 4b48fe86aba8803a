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
reference's ``vmap``.

The ``auto`` scheme's feedback loop is here too: ``compress_profile``
(the configured keep-density's worst case), ``measured_profile`` (from
the measured d(1) and d(n)) and :class:`DensityController`, which folds
the ``sync/ef_density*`` metrics into EMAs and says when
``costmodel.choose_scheme`` would pick another scheme for a bucket.
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


def compress_profile(cfg: CompressConfig, size: int, vw: int = 1):
    """Offline worst-case profile of a compressed bucket: the configured
    keep-density with no-overlap densification (the adversarial case for
    Zen's pull), what ``choose_scheme`` uses before measurements exist."""
    from repro_torch.core import costmodel  # deferred: costmodel imports metrics, which imports us

    return costmodel.worst_case_profile(size, cfg.density, vw=vw)


def measured_profile(size: int, d1: float, dn: float, n: int, vw: int = 1):
    """Profile from the two measured densification points the runtime
    reports: d(1) (local, post-compression) and d(n) (post-aggregation).
    Intermediate i interpolate linearly; only d(1) and d(n) enter the
    zen/dense volume formulas."""
    from repro_torch.core import costmodel  # deferred: see compress_profile

    d1 = float(min(max(d1, 0.0), 1.0))
    dn = float(min(max(dn, d1), 1.0))

    def d(i: int) -> float:
        if n <= 1:
            return d1
        t = (min(max(i, 1), n) - 1) / (n - 1)
        return d1 + (dn - d1) * t

    return costmodel.SparsityProfile(M=size, d=d, s=lambda k: 1.0, vw=vw)


class DensityController:
    """Feed measured post-compression density back into scheme selection.

    The bucket plan's schemes are fixed when GradSync is built, but the
    density top-k/threshold produces drifts during training.  The
    controller closes the loop from the host:

        stats = train_step(...)            # sync/ef_density* metrics
        controller.observe(stats)          # EMA update
        if controller.drifted():           # choose_scheme disagrees
            profiles = controller.profiles()
            ...rebuild GradSync with profiles...

    Bucket boundaries never depend on schemes or profiles, so keys and
    residual shapes are stable across replans: the optimizer state
    carries over untouched."""

    def __init__(self, bucket_sizes: dict[str, int], schemes: dict[str, str],
                 n: int, *, ema: float = 0.8, threshold: float = 1.0,
                 topology=None, calib=None):
        """``bucket_sizes``/``schemes``: per compressed-bucket key (from
        ``GradSync.compressed_buckets()`` / ``bucket_schemes()``).  ``n``
        is the sync world size; ``threshold`` mirrors
        ``SyncConfig.auto_threshold``.  ``topology`` makes the decision
        one over CommPlan tags (``costmodel.choose_scheme``); ``calib``
        (a ``costmodel.CalibrationTable``, e.g. ``gradsync.calib``) makes
        the re-run decision encode-cost-aware, priced as the live plan
        was (DESIGN.md §11)."""
        self.sizes = dict(bucket_sizes)
        self.current = dict(schemes)
        self.n = max(n, 2)
        self.topology = topology
        self.calib = calib
        self.ema = float(ema)
        self.threshold = float(threshold)
        self._d1: dict[str, float] = {}
        self._dn: dict[str, float] = {}

    def observe(self, stats: dict) -> None:
        """Fold one step's metrics (host floats or 0-d tensors) into the
        per-bucket density EMAs.  Unknown keys are ignored, so the whole
        metrics dict can be passed as it is."""
        for key in self.sizes:
            for store, pattern in ((self._d1, DENSITY1_KEY),
                                   (self._dn, DENSITYN_KEY)):
                v = stats.get(pattern.format(key=key))
                if v is None:
                    continue
                v = float(v)
                old = store.get(key)
                store[key] = v if old is None else (
                    self.ema * old + (1 - self.ema) * v)

    def profiles(self) -> dict:
        """Measured profiles for every bucket with observations: the dict
        to pass to ``GradSync(profiles=...)`` on a replan."""
        out = {}
        for key, size in self.sizes.items():
            if key in self._d1 and key in self._dn:
                out[key] = measured_profile(
                    size, self._d1[key], self._dn[key], self.n)
        return out

    def schemes(self) -> dict[str, str]:
        """choose_scheme on the measured profile per bucket; buckets with
        no observations yet keep their current scheme."""
        from repro_torch.core import costmodel  # deferred: see compress_profile

        out = dict(self.current)
        target = self.topology if self.topology is not None else self.n
        for key, prof in self.profiles().items():
            out[key] = costmodel.choose_scheme(
                prof, target, threshold=self.threshold, calib=self.calib)
        return out

    def drifted(self) -> dict[str, tuple[str, str]]:
        """``{key: (current, recommended)}`` where they disagree: truthy
        iff a replan would change at least one bucket's scheme."""
        rec = self.schemes()
        return {k: (self.current[k], rec[k])
                for k in self.current if rec[k] != self.current[k]}

    def rebase(self, schemes: dict[str, str]) -> None:
        """Record the schemes the rebuilt plan resolved (call after a
        replan, so drift is measured against the live plan)."""
        self.current = dict(schemes)
