"""Quickstart of the PyTorch port: Zen sparse gradient synchronization.

The port of ``examples/quickstart.py``:

1. Build skewed sparse gradients on 8 simulated workers.
2. Synchronize them with Zen (hierarchical hashing + hash bitmap) on the
   kernel route (the CUDA kernels on the card).
3. Verify exactness against the dense allreduce and compare wire volume.
4. Rerun under FULL skew (one worker holds every non-zero) with the
   balanced Ok-Topk-style scheme (``--sync balanced`` on
   ``repro_torch.launch.train``): its histogram rebalance bounds every
   worker's buffers by nnz_total / n plus one bin's slack, where agsparse
   must provision the whole total.
5. Induce sparsity on DENSE gradients with error-feedback top-k
   (``--compress topk:0.01``) and watch ``auto`` route them through Zen.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import metrics, schemes
from repro_torch.core.registry import BALANCED_BINS
from repro_torch.core.zen import GradSync, SyncConfig

N_WORKERS = 8
TENSOR = 1 << 16          # embedding-gradient rows
DENSITY = 0.03


def full_skew(nnz_total: int) -> np.ndarray:
    """[N_WORKERS, TENSOR] f32: every non-zero (value 1) on worker 0, at
    positions drawn by ``np.random.default_rng(0)``."""
    skewed = np.zeros((N_WORKERS, TENSOR), np.float32)
    hot = np.random.default_rng(0).choice(TENSOR, nnz_total, replace=False)
    skewed[0, hot] = 1.0
    return skewed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    masks = metrics.synth_sparse_masks(0, N_WORKERS, TENSOR, DENSITY).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    grads = torch.randn((N_WORKERS, TENSOR), generator=gen).to(dev) * masks
    print(f"workers={N_WORKERS} tensor={TENSOR} "
          f"density={float(metrics.density(masks[0])):.3%} "
          f"skew(16)={float(metrics.skewness_ratio(masks[0], 16)):.1f} "
          f"densification(8)="
          f"{float(metrics.densification_ratio(masks)):.2f}")

    # --- Zen, on the kernel route -------------------------------------------
    layout = schemes.make_zen_layout(TENSOR, N_WORKERS, density_budget=0.08)
    zen_out, zen_stats = schemes.simulate(schemes.zen_sync, grads,
                                          layout=layout, backend="cuda")

    # --- dense oracle --------------------------------------------------------
    dense_out, dense_stats = schemes.simulate(schemes.dense_sync, grads)

    err = float((zen_out - dense_out).abs().max())
    zen_words = float(zen_stats.sent_words.mean())
    dense_words = float(dense_stats.sent_words.mean())
    print(f"max |zen - allreduce| = {err:.2e}  (no information loss)")
    print(f"wire volume: zen={zen_words:,.0f} words, "
          f"allreduce={dense_words:,.0f} words "
          f"-> {dense_words / zen_words:.1f}x less traffic")
    assert err < 1e-5

    # --- balanced under full skew (--sync balanced) --------------------------
    nnz_total = int(TENSOR * DENSITY)
    skewed = torch.as_tensor(full_skew(nnz_total), device=dev)
    bal_cap = nnz_total // N_WORKERS \
        + min(nnz_total, N_WORKERS * (TENSOR // BALANCED_BINS))
    bal_out, bal_stats = schemes.simulate(
        schemes.balanced_sync, skewed, n=N_WORKERS,
        cap_push=bal_cap, cap_pull=bal_cap, backend="cuda")
    ags_out, ags_stats = schemes.simulate(
        schemes.agsparse_sync, skewed, capacity=nnz_total,  # needs nnz_max!
        backend="cuda")
    assert int(bal_stats.overflow.sum()) == 0
    want = skewed.sum(0)
    assert torch.allclose(bal_out, want.expand_as(bal_out), atol=1e-5)
    assert torch.allclose(ags_out, want.expand_as(ags_out), atol=1e-5)
    bal_max = float(bal_stats.sent_words.max())
    ags_max = float(ags_stats.sent_words.max())
    print(f"full skew, {nnz_total} nonzeros all on worker 0: "
          f"balanced bottleneck={bal_max:,.0f} words "
          f"(buffers {bal_cap}/worker, skew-independent) vs "
          f"agsparse={ags_max:,.0f} (capacity must be nnz_max={nnz_total}) "
          f"-> {ags_max / bal_max:.1f}x less at the bottleneck")

    # --- induced sparsity: EF top-k on a DENSE gradient tree -----------------
    leaves = [(f"mlp/w{i}", (4096,), torch.float32) for i in range(8)]
    dense_grads = {nm: torch.randn((N_WORKERS, 4096), generator=gen).to(dev)
                   for nm, _, _ in leaves}
    gs = GradSync(SyncConfig(scheme="auto", compress="topk:0.01",
                             bucket_bytes=1 << 14), [], leaves, N_WORKERS)
    _, resid, stats = gs(dense_grads, gs.init_residual(dev))
    wire = float(stats["sync/sparse_sent_words"].mean()) \
        + float(stats["sync/dense_words"].mean())
    ring = 2 * (N_WORKERS - 1) / N_WORKERS * 8 * 4096
    print(f"EF top-k 1% on dense grads: schemes={gs.bucket_schemes()} "
          f"wire={wire:,.0f} vs allreduce={ring:,.0f} words "
          f"({wire / ring:.1%}); dropped mass held in "
          f"{len(resid)} residual buckets")
    assert wire < 0.10 * ring
    return {"zen_err": err, "zen_words": zen_words,
            "dense_words": dense_words, "skewed": full_skew(nnz_total),
            "bal_cap": bal_cap, "nnz_total": nnz_total,
            "bal_words": bal_stats.sent_words.cpu().numpy(),
            "ags_words": ags_stats.sent_words.cpu().numpy(),
            "ef_wire": wire, "ef_ring": ring,
            "ef_schemes": gs.bucket_schemes()}


if __name__ == "__main__":
    main()
