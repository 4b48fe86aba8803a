"""Sparsity characteristics of gradient tensors (§2.2, Defs. 3-6); port
of ``repro.core.metrics``.

Every metric takes boolean non-zero masks (element or row granularity)
and returns an f32 tensor.  Means are taken as the reference's f32
``jnp.mean``: the count times the f32 reciprocal of the length
(``sparsify.density``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sparsify


def density(mask: torch.Tensor) -> torch.Tensor:
    """d_G: the f32 fraction of non-zero gradients of the whole mask."""
    return sparsify.density(mask.reshape(-1))


def _f32_sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """f32 count of True (exact below 2**24)."""
    x = x.to(torch.float32)
    return x.sum() if dim is None else x.sum(dim)


def _f32_mean(x: torch.Tensor) -> torch.Tensor:
    """f32 mean of a vector: its sum times the f32 reciprocal of its
    length."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return x.sum() * (one / float(x.shape[0]))


def overlap_ratio(mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """Def. 3: |I1 ∩ I2| / min(|I1|, |I2|)."""
    inter = _f32_sum(mask_a & mask_b)
    lo = torch.minimum(_f32_sum(mask_a), _f32_sum(mask_b))
    return inter / torch.clamp(lo, min=1.0)


def aggregated_mask(masks: torch.Tensor) -> torch.Tensor:
    """Union of per-worker masks [n, M] -> [M] (non-zeros after
    aggregation; exact value cancellation is ignored, as in the paper)."""
    return masks.any(dim=0)


def densification_ratio(masks: torch.Tensor) -> torch.Tensor:
    """Def. 4: γ_G^n = d_G^n / d_G, with d_G the mean per-worker density."""
    d_n = density(aggregated_mask(masks))
    d_1 = _f32_mean(sparsify.density(masks))
    return d_n / torch.clamp(d_1, min=1e-12)


def skewness_ratio(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Def. 5: s_G^n = max_i d_{G_i} / d_G over n equal contiguous
    partitions."""
    m = mask.shape[0]
    if m % n:
        raise ValueError(f"mask length {m} must divide by n={n} for even "
                         f"partitioning")
    parts = sparsify.density(mask.reshape(n, m // n))
    return parts.max() / torch.clamp(density(mask), min=1e-12)


def imbalance_ratio_push(part_counts: torch.Tensor) -> torch.Tensor:
    """Def. 6 (Push): max_{i,j} n |I_i^j| / |I_i|.

    ``part_counts``: int [n_workers, n_servers], worker i's non-zeros
    routed to server j."""
    n_srv = part_counts.shape[1]
    totals = part_counts.sum(dim=1, keepdim=True).to(torch.float32)
    frac = part_counts.to(torch.float32) / torch.clamp(totals, min=1.0)
    return n_srv * frac.max()


def imbalance_ratio_pull(server_counts: torch.Tensor) -> torch.Tensor:
    """Def. 6 (Pull): max_i n |𝕀_i| / |I| over aggregated per-server sets."""
    n = server_counts.shape[0]
    total = server_counts.sum().to(torch.float32)
    return (n * server_counts.to(torch.float32).max()
            / torch.clamp(total, min=1.0))


def synth_sparse_masks(seed: int, n_workers: int, length: int,
                       density_target: float, *, skew: float = 1.5,
                       shared_frac: float = 0.5) -> torch.Tensor:
    """Draw [n_workers, length] masks with the paper's characteristics:
    Zipf-like non-zero positions (C3 skew), ``shared_frac`` of each
    worker's draws from a shared hot set (C1 partial overlap), the rest
    worker-private.

    ``seed`` seeds ``np.random.default_rng``.  The reference derives that
    integer from its JAX key with threefry
    (``jax.random.randint(key, (), 0, 2**31 - 1)``); pass the same
    integer to draw its masks."""
    nnz = max(1, int(length * density_target))
    rng = np.random.default_rng(int(seed))
    ranks = np.arange(1, length + 1, dtype=np.float64)
    p = ranks ** (-skew)
    p /= p.sum()

    def draw_exact(r, k):
        """Draw until exactly k UNIQUE Zipf positions."""
        got = np.unique(r.choice(length, size=4 * k, p=p))
        while len(got) < k:
            got = np.unique(np.concatenate(
                [got, r.choice(length, size=2 * k, p=p)]))
        r.shuffle(got)
        return got[:k]

    hot = draw_exact(rng, nnz)  # shared hot set
    masks = []
    for _ in range(n_workers):
        n_shared = int(nnz * shared_frac)
        own = draw_exact(rng, nnz)
        sh = rng.choice(hot, size=n_shared, replace=False)
        rest = own[~np.isin(own, sh)][: nnz - n_shared]
        m = np.zeros(length, bool)
        m[np.concatenate([sh, rest])] = True
        masks.append(m)
    return torch.from_numpy(np.stack(masks))
