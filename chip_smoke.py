"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: a CUDA GPU must be present; prints its name and power limit.
  2. kernels: builds the CUDA kernels from ``src/repro_torch/csrc`` and
     holds each against its plain PyTorch version on the card at the
     qwen2-0.5b Zen slice shapes (M = 151936 embedding rows, d = 896,
     n = 8): a realistic stream (512 tokens per rank), a dense stream near
     the capacity budget, and an overflow-edge layout; f32 and bf16; for
     the scatter-add also a non-zero ``out`` with EMPTY, negative and
     out-of-range indices, one target repeated 64 and 4096 times, and
     every row a distinct target, each case twice in a row (the kernel
     keeps its scratch across calls); for the encode also a skew stream
     whose partition 0 holds 12000 candidates (its list in the global
     scratch); for the push also a cancellation stream (occupied slots
     whose rows sum to zero, one slot of -0.0 rows, which the mask drops);
     for the row compaction and the hash stage also their edge shapes
     (short, long, all-EMPTY, all-live and unaligned rows; index vectors
     of 0 to C + 3 entries, k = 1 and 15, n = r1 = 1, top-bit seeds); for
     the bitmap pair its row and 1-D forms at the call shapes (all n
     server masks [n, cap_server], the encode's occupancy [n, r1 + r2],
     the pull's unpack into [n, cap_server]), rows cut to 1-33 bits and
     all-zero / all-one rows.
     Each fused kernel is also held against its unfused chain.
     Every output must be bitwise equal.
  2b. kernels_wide: the three fused Zen kernels at the EF-compressed
     path's widest shapes, n = 8, topk:0.01 (a 25 MiB bucket of 13,074,432
     elements; ``lm_head/w``, 136,134,656), on their wide paths (the
     encode's row and ballots, the push's bitmap prefix and the pull's row
     scan out of shared memory) while the slice shapes stay on the
     shared-memory paths: bitwise against their plain versions, twice in a
     row, the push in bf16 and f32; at the 25 MiB bucket also the unfused
     chain's five kernels.  Timed with the times phase.
  2c. new_shapes: the three fused Zen kernels at the shapes the two-level
     and zoo paths give them: the inter stage of nodes of 4 (2 servers of
     the node sums, budget 1: C 151936, r1 + r2 167130, the encode on its
     wide path at d 896), the zoo trainers' tables (qwen2.5-3b d 2048,
     phi4-mini d 3072 and vocab 200064, 2 ranks) and phase 7g's tables
     (zamba2-1.2b 32000 x 2048, olmoe-1b-7b 50304 x 2048, phi3.5-moe 32064
     x 4096, 2 ranks): bitwise their plain versions, twice in a row; timed
     with the times phase.
  3. zen_sync: n = 8 simulated ranks at M = 151936, d = 896, bf16;
     ``backend="cuda"`` must equal ``backend="torch"`` bitwise, on the
     fused route and with (fused, fused_commit) in {(F,T), (T,F), (F,F)}.
  4. trainer: ``launch/train.py --arch qwen2-0.5b --mesh 8x1 --sync zen
     --global-batch 8 --seq-len 512 --steps 4`` at full width and depth;
     finite, falling loss, no overflow, every fused-route kernel launched
     8 x steps times, no call on the plain route.  Then the same trainer
     with ``SyncConfig(fused_encode=False, fused_commit=False)``: the same
     checks on the unfused chain's five kernels (``bitmap_pack`` once a
     step: all 8 server masks in one launch; the others 8 x steps), the
     fused kernels not launched, the fused run's wire words, losses within
     5e-3 of it.
  5. breakdown: one profiled trainer step (torch.profiler): device time by
     kernel category and the device's idle share.
  5b. buckets: the phase-4 trainer with ``--bucket-bytes 26214400`` (25
     MiB, PyTorch DDP's default bucket cap) beside the per-leaf run:
     losses, grad norm, wire words and overflow bitwise equal, Zen's
     kernels 8 x steps times each, nothing plain; the plans and the step
     times are logged.
  5c. overlap: GradSync with 25 MiB buckets at the qwen2 slice shapes (the
     [M, d] table between two fused dense buckets, 8 ranks) on its two
     streams against ``schedule.run_in_order`` on one, bitwise, 5 repeats,
     on the fused route and the unfused chain; then one profiled bucketed
     trainer step: the share of the encodes' device time (GradSync's side
     stream) inside other streams' kernels, and the idle share.
  6. serve_kernels: the models' prefill kernels against their plain
     versions at the serve shapes, within stated tolerances (the sums run
     in another order): ``flash_fwd`` at the qwen2-0.5b prefill (B 8,
     S 512, 14 q heads on 2 KV heads, hd 64, causal) in bf16 (one bf16 ulp;
     the tensor-core kernel) and f32 (2e-5; the FMA kernel), then S 500,
     KV = H, window 64, non-causal, a decode-style q_offset, KV = 1 and
     hd 32 with window 64, then the wide head dims: the qwen2.5-3b prefill
     (16 q heads on 2 KV heads, hd 128), the pixtral-12b prefill (32 on 8,
     hd 160), S 500 at both and window 64 at hd 128; ``ssd_fwd`` at the
     mamba2-370m prefill (B 8,
     S 512, 32 heads, hd 64, N 128, Q 64; 2e-4), at S 500 through
     ``_ssd_chunked``'s padding (with D != 0) and at Q 16.
  7. serve: ``launch/serve.py`` for qwen2-0.5b and mamba2-370m at full
     width and depth, batch 8, prompt 512, 16 new tokens: twice on the
     kernels in the config's bf16 (timed; 24 flash_fwd / 48 ssd_fwd
     launches per prefill, no plain call), then in f32 on the kernels and
     on the plain route (``--backend torch``): prefill logits within 1e-3
     (qwen2) / 1e-2 (mamba2, beside the logit shift that merely reordering
     the plain scan gives) and the same greedy tokens.  One profiled bf16
     prefill per model.
  7b. mamba2_train: the mamba2-370m trainer (``build_program`` +
     ``attach_train``, as ``launch/train.py --mesh 8x1`` builds it) at full
     width and 24 of its 48 layers, so that the whole run stays inside its
     time limit (global batch 8 x 512, Zen on ``embed/table``, 4 steps):
     finite loss, 0 overflow, ``ssd_fwd`` launched
     24 x 8 x steps times under ``SSDScan`` with as many plain recomputes
     in its backward, Zen's kernels 8 x steps times, nothing plain; the
     plain route (``--backend torch``): step-0 loss within 5e-3, the same
     wire words; ``SSDScan``'s gradients at a rank's shape bitwise those
     of autograd through the plain scan; ten finite steps (loss and
     grad norm) on one repeated batch at 1x1, logged (at this depth the
     loss moves by noise over a few steps, the reference's too at 12
     layers, so no check asks it to fall); step time, tok/s, peak memory
     and one profiled step (``ssd_fwd``'s device ms, idle share).
  7c. compress: EF compression on the qwen2-0.5b 8x1 trainer at full
     width and depth, 25 MiB buckets, ``--sync zen --compress topk:0.01``
     (98 compressed dense buckets and the embedding, all on Zen's fused
     kernels), 4 steps: finite losses, every fused kernel launched 8 x 99
     times a step, nothing plain, words under 10 % of the dense buckets'
     uncompressed words; at step 0 the EF invariant bitwise for every
     bucket, and Zen on each bucket's sent payload against its psum
     (within the summation bound, or zero where Zen's capacity dropped a
     slot, which only the 896-element norm-scale buckets may do); the
     plain route (``--backend torch``, 1 step, about a minute): losses,
     words, overflow and residual digests bitwise; ``--sync dense --compress topk:0.01``:
     the same step-0 loss and residual digest; step time, tok/s, peak
     memory and one profiled step.
  7d. schemes: the paper's baselines (agsparse, sparcml, sparse_ps,
     omnireduce, balanced) at the slice's full width (M 151936, d 896,
     n 8, bf16, ``stage_args_for`` at budget 0.25, through
     ``stage_sync``) on the Zipf stream (random values, and rounded to
     multiples of 1/8) and a 0.2 row-density stream (multiples of 1/8):
     ``backend="cuda"`` bitwise ``"torch"`` (outputs, words, overflow),
     ``coo_scatter_add`` launched and nothing plain, overflow 0, on the
     dyadic streams every worker exactly the psum; ms a sync on both
     routes; ``coo_scatter_add`` timed at agsparse's reduce (row 8b: 8 x
     37984 EMPTY-padded rows into [151936, 896]) against ``index_add_``.
     Then the full-size 8x1 trainer: ``--sync auto`` 4 steps (the plan
     puts zen on ``embed/table``; losses and words bitwise ``--sync
     zen``'s, the trainer phase's run), each scheme 2 steps on the
     kernels (bitwise its ``--backend torch`` run; within 1e-3 of zen's
     losses; ``coo_scatter_add`` launched, the Zen kernels not, nothing
     plain, overflow 0).
  7e. hier: the qwen2-0.5b 8x1 trainer of phase 4 on two-level
     topologies: ``--node-size 4`` and ``2``, each with ``--sync zen`` and
     ``--sync auto``, and ``--node-size 2 --bucket-bytes 26214400``: 4
     steps on the kernels beside 2 on the plain route (``--backend
     torch``): losses, grad norm, words at each level
     (``sync/intra_words``, ``sync/inter_words``) and overflow bitwise,
     the step-0 loss the flat run's bits and later losses within 5e-3 of
     its (the psums add in another order, in bf16), the Zen kernels launched at
     both levels under zen (16 of each a step), ``auto``'s plans the
     reference's (``hier(sparcml@intra,dense@inter)`` at 4,
     ``hier(agsparse@intra,zen@inter)`` at 2) with ``coo_scatter_add``
     launched, nothing plain; the ``describe()`` lines, words, step times
     and peak memory are logged.
  7f. zoo: qwen2.5-3b and phi4-mini: served at full size as in phase 7
     (bf16 timed, ``flash_fwd`` at hd 128 in every layer of every
     prefill; f32 kernels vs plain within 1e-3 and the same tokens; one
     profiled prefill), then trained at full width on a 2x1 mesh (2 x 512
     tokens, Zen on ``embed/table``, 2 steps) at the depth ``ZOO`` sets
     (28 and 16 layers: the peak must stay under 70 GiB), the kernel
     route bitwise its plain route, the peak memory logged.
  7g. hybrid_moe: zamba2-1.2b (38 Mamba2 layers and one shared attention
     block at the start of each of its 6 groups), olmoe-1b-7b (64 experts,
     top-8) and phi3.5-moe-42b-a6.6b (16 experts, top-2; 12 of its 32
     layers: 41.9B parameters do not fit one card) served as in phase 7
     (``launch/serve.py``, bf16 timed twice; every prefill on the kernels
     at the launches ``HYBRID_MOE`` expects: zamba2 6 ``flash_fwd`` and 38
     ``ssd_fwd``, olmoe 16, phi3.5-moe 12 ``flash_fwd``; f32 kernels vs the
     plain route within 1e-1 (zamba2, beside the controls that reorder the
     plain scan's and the plain attention's sums) / 1e-3 (MoE), the same
     greedy tokens (zamba2's sequences may part only at a token whose
     top-2 gap is under 1e-1 on both routes), the smallest top-2 gap
     logged; one profiled bf16 prefill), then trained at full width on 2x1 (2 x 512
     tokens, Zen on ``embed/table``, 2 steps) at the depths ``HYBRID_MOE``
     sets (38, 6 and 2 layers; the peak under 70 GiB) on both routes: the
     MoE models' losses, grad norm, words, overflow and MoE stats
     (``moe/aux_loss``, ``moe/dropped``, ``moe/skew``) bitwise, zamba2's
     words and overflow bitwise and its losses within 5e-2 (its scan is
     ``ssd_fwd`` on one route only; a plain run with the scan's chunk
     halved logged as a control), overflow 0, the Zen kernels
     once a rank a step, zamba2's ``ssd_fwd`` 38 x 2 x 2 times with as many
     plain recomputes, nothing plain.  Then the prefill kernels at the
     new shapes (bf16 ``flash_fwd`` B 8, S 512 at 32 / 32 heads of 64, 16 /
     16 and 32 / 8 of 128; f32 ``ssd_fwd`` at H 64, hd 64, N 64, Q 64)
     against their plain versions (one bf16 ulp, 2e-4) and bitwise equal
     across two calls, timed beside SDPA and the bound (rows 9d-9f, 10b).
  8. dist (run right after the build, while this process holds no card
     memory: four full-width ranks need most of it): data parallelism over
     a real ``torch.distributed`` gloo group, one process per rank, every
     rank on this one card (NCCL refuses two ranks on one device), started
     by ``torchrun`` after the parent built the kernels: ``zen_sync`` at the slice shapes on 8 ranks, each rank's
     output and stats bitwise row w of the in-process ``simulate`` on the
     card (sha256 digests) on all four (fused, fused_commit) routes, each
     route's kernels launched once per rank, no plain call, and the five
     baseline schemes the same way, and ``hier_sync`` of four two-level
     plans (Zen at both levels, and ``auto``'s plans) over nodes of 4 and
     2 ranks, the level groups made by ``dist.new_group``, each rank's
     digest (words by level included) bitwise its ``simulate_hier`` row
     (``--only dist_sync`` runs this part alone); then
     ``launch/train.py --arch qwen2-0.5b --mesh 4x1 --dist gloo`` at full
     width and depth (4 steps; 4 ranks, as a rank takes about 12 GB), per
     leaf, with 25 MiB buckets and with ``--node-size 2`` (``--only
     dist_hier`` runs this one alone), against the in-process 4x1 trainer
     on the same topology: losses finite,
     falling and within 5e-3 of it, the same wire words, no overflow,
     ``zen_encode``, ``zen_commit_push`` and ``zen_commit_pull`` launched
     once a step on every rank (twice on nodes of 2: once a level), no
     plain call, the words at each level the in-process run's; the runs'
     step times and tok/s are logged.  Not in the default run: ``--only dist_parts`` logs
     where each one's step goes on the host's clock, per leaf and with 25
     MiB buckets (``step_parts``:
     forward and backward, Zen's sync and the whole GradSync, the last two
     on zero gradients; rank 0 of 4 gloo ranks, and the in-process run),
     and ``--only dist_nccl``, on four cards, runs the same trainer check
     with ``--dist nccl``, a rank a card.
  9. times: median of 20 CUDA-event timings of each kernel and its plain
     version at the slice and serve shapes, with the least time the card
     could take and, where one PyTorch call computes the same function,
     that call's time.  ``ms`` has the events around one call, the
     wrapper's host work included; ``device_ms`` (and
     ``library_device_ms``) queue a spin kernel before the start event so
     that the host has queued the whole call before the device reaches
     it: the events then bound device work only.  ``ssd_fwd``'s row also
     gives its bound at a third of the TF32 tensor-core rate (its split
     products); beside the table, the scatter-add, the encode, the
     commit push, the hash stage and the row compaction are timed once
     more at phase 2's dense stream, and ``flash_fwd`` at the qwen2.5-3b
     and pixtral-12b prefill shapes against SDPA; the fused Zen kernels
     at phase 2c's new shapes (rows 1e-3g).  The hash stage's, the
     row compaction's, the push's and the pull's device time by launch
     (torch.profiler), the push's grid and its kept scratch are logged.
     Then the bitmap pair at its call sites on the realistic and dense
     streams (``bitmap_times``; ``--only bitmap_times`` runs it alone):
     device time, device time by launch, and a ``zero_()`` of each call's
     output bytes beside it.

The third line from the end is the kernel table as JSON, the second the
card's name and power limit (``nvidia-smi``), the last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# H100 SXM float32 rate outside the tensor cores (data sheet); the integer
# and float work of these kernels runs on the same units, at most this fast
OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
SLICE = dict(M=151936, d=896, n=8, density_budget=0.25, tokens=512)
SERVE = dict(batch=8, prompt=512, gen=16)
FLASH = dict(B=8, S=512, H=14, KV=2, hd=64)       # qwen2-0.5b prefill
SSD = dict(B=8, S=512, H=32, hd=64, N=128, Q=64)   # mamba2-370m prefill
# qwen2.5-3b (16 q / 2 KV heads) and pixtral-12b (32 / 8) prefills
FLASH_WIDE = {"qwen2.5-3b": dict(B=8, S=512, H=16, KV=2, hd=128),
              "pixtral-12b": dict(B=8, S=512, H=32, KV=8, hd=160)}
FLASH_F32_TOL = 2e-5       # the reference's own flash test
SSD_TOL = 2e-4             # the reference's own SSD test (atol and rtol)
# f32 prefill logits, kernels vs plain route.  Random-init Mamba2 carries a
# rounding difference through its 48 layers far more than qwen2's 24
# attention layers do: reordering the plain route's own scan (chunk 32 for
# 64) moves its logits further than the kernel route does (the serve phase
# logs both), so mamba2's gate is 10x qwen2's.
# zamba2's shared attention block feeds 38 Mamba2 layers: at random init
# a reordered f32 sum there moves its logits further still (0.051 when the
# plain attention's KV chunk alone goes from 512 to 64), so its gate is
# 10x mamba2's; the serve phase logs the controls beside the kernel
# route's difference.
SERVE_LOGIT_TOL = {"qwen2-0.5b": 1e-3, "mamba2-370m": 1e-2,
                   "zamba2-1.2b": 1e-1}
SERVE_KERNEL = {"qwen2-0.5b": "flash_fwd", "mamba2-370m": "ssd_fwd"}
REPLACES = {
    "zen_encode": "src/repro/kernels/zen_encode.py:108",
    "zen_commit_push": "src/repro/kernels/zen_commit.py:104",
    "zen_commit_pull": "src/repro/kernels/zen_commit.py:163",
    "hash_stage": "src/repro/kernels/hash_stage.py:56",
    "row_compact": "src/repro/kernels/compact.py:49",
    "coo_scatter_add": "src/repro/kernels/scatter_add.py:44",
    "bitmap_pack": "src/repro/kernels/bitmap.py:38",
    "bitmap_unpack": "src/repro/kernels/bitmap.py:54",
    "flash_fwd": "src/repro/kernels/flash.py:66",
    "ssd_fwd": "src/repro/kernels/ssd.py:57",
}
SOURCES = {
    "zen_encode": "src/repro_torch/csrc/zen_encode.cu",
    "zen_commit_push": "src/repro_torch/csrc/zen_commit.cu",
    "zen_commit_pull": "src/repro_torch/csrc/zen_commit.cu",
    "hash_stage": "src/repro_torch/csrc/hash_stage.cu",
    "row_compact": "src/repro_torch/csrc/row_compact.cu",
    "coo_scatter_add": "src/repro_torch/csrc/scatter_add.cu",
    "bitmap_pack": "src/repro_torch/csrc/bitmap.cu",
    "bitmap_unpack": "src/repro_torch/csrc/bitmap.cu",
    "flash_fwd": "src/repro_torch/csrc/flash_fwd.cu",
    "ssd_fwd": "src/repro_torch/csrc/ssd_fwd.cu",
}
UNFUSED = dict(fused_encode=False, fused_commit=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor's bits, for bitwise comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def same(a, b, what: str) -> float:
    """Assert kernel outputs ``a`` equal plain outputs ``b`` bit for bit;
    returns the largest absolute difference (0.0 when they are equal)."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape == y.shape and x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        if x.shape != y.shape or x.dtype != y.dtype \
                or not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version ({x.dtype} {tuple(x.shape)} vs "
                                 f"{y.dtype} {tuple(y.shape)}, max abs "
                                 f"difference {worst})")
    return worst


def zipf_rows(rng, n: int, vocab: int, tokens: int, d: int, dtype, dev):
    """[n, vocab, d] worker gradients: each worker's rows are the distinct
    ids of ``tokens`` Zipf(1.2) draws (the trainer's data law), random
    values."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.2
    p /= p.sum()
    g = torch.zeros((n, vocab, d), dtype=dtype, device=dev)
    for w in range(n):
        ids = np.unique(rng.choice(vocab, size=tokens, p=p))
        idx = torch.as_tensor(ids, device=dev)
        v = torch.as_tensor(rng.standard_normal((ids.size, d)), device=dev)
        g[w, idx] = v.to(dtype)
    return g


def dense_rows(rng, n: int, vocab: int, density: float, d: int, dtype, dev):
    """[n, vocab, d] worker gradients with a uniform row density."""
    g = torch.zeros((n, vocab, d), dtype=dtype, device=dev)
    for w in range(n):
        idx = torch.as_tensor(np.flatnonzero(rng.random(vocab) < density),
                              device=dev)
        g[w, idx] = torch.randn((idx.numel(), d), device=dev).to(dtype)
    return g


def kernel_inputs(g: torch.Tensor, lo):
    """The kernels' inputs on the zen_sync path for worker/server 0: the
    compacted index vector, its Alg. 1 memory, the server's pushed stream,
    every server's aggregated mask [n, cap_server] (what the unfused
    commit packs in one call), worker 0's encode occupancy [n, r1 + r2]
    and the gathered server bitmaps (built with the plain route)."""
    from repro_torch.core import schemes as S
    from repro_torch.core.hashing import EMPTY, compact_rows, hierarchical_hash
    from repro_torch.kernels import ref as R

    enc = S.zen_encode(g, layout=lo, backend="torch")
    idx = compact_rows(S._worker_mask(g), lo.cap_index)[0][0].contiguous()
    grp = S.SimGroup(lo.n)
    got_idx = grp.all_to_all(enc.pidx).reshape(lo.n, -1)
    got_val = grp.all_to_all(enc.pval).reshape(lo.n, -1, g.shape[-1])
    tab = lo.tables(g.device)["local_pos"]
    live = got_idx != EMPTY
    lp = torch.where(live, tab[torch.where(live, got_idx, 0).long()],
                     lo.cap_server).to(torch.int32)
    bms = torch.stack([
        R.zen_commit_push_ref(lp[s], got_val[s], cap_server=lo.cap_server,
                              cap_pull=lo.cap_pull)[2]
        for s in range(lo.n)])
    mem = hierarchical_hash(idx, n=lo.n, r1=lo.r1, r2=lo.r2, k=lo.k,
                            seeds=lo.static_seeds()).memory
    masks = torch.stack([
        (R.coo_scatter_add_ref(lo.cap_server, lp[s], got_val[s]) != 0)
        .any(dim=-1) for s in range(lo.n)])
    return dict(idx=idx, mem=mem, lp=lp[0].contiguous(),
                vals=got_val[0].contiguous(), masks=masks,
                occ=enc.pidx[0] != EMPTY, bms=bms)


def scatter_cases(lp: torch.Tensor, vals: torch.Tensor, rows: int, rng):
    """(name, out, idx, vals) cases for the scatter-add at the server's
    shapes: the pushed stream into zeros; a non-zero ``out`` with EMPTY,
    negative and out-of-range indices mixed in; one target repeated 64
    times among the others, and 4096 times; every row a distinct target
    (T = C = rows)."""
    dev = vals.device
    cases = [("stream", torch.zeros((rows, vals.shape[1]), dtype=vals.dtype,
                                    device=dev), lp, vals)]
    idx = lp.clone()
    pick = torch.as_tensor(rng.random(idx.numel()) < 0.02, device=dev)
    junk = torch.as_tensor(rng.choice([2**31 - 1, -1, -7, rows, rows + 5],
                                      size=idx.numel()), device=dev)
    idx = torch.where(pick, junk.to(torch.int32), idx).contiguous()
    out = torch.randn((rows, vals.shape[1]), device=dev).to(vals.dtype)
    out[torch.as_tensor(rng.random(rows) < 0.5, device=dev)] = 0
    cases.append(("nonzero-out+junk", out, idx, vals))
    for reps in (64, 4096):
        rep = lp.clone()
        live = torch.nonzero(lp < rows)[:, 0] if reps == 64 \
            else torch.arange(lp.numel(), device=dev)
        rep[live[torch.as_tensor(rng.choice(live.numel(), reps,
                                            replace=False), device=dev)]] = 3
        cases.append((f"repeat{reps}", out, rep.contiguous(), vals))
    perm = torch.as_tensor(rng.permutation(rows), dtype=torch.int32,
                           device=dev)
    cases.append(("distinct", out, perm, vals[:rows].contiguous()))
    return cases


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def cuda_device_ms(fn, iters: int = 20) -> float | None:
    """Median of ``iters`` CUDA-event timings of ``fn`` with the host's
    work hidden: a spin kernel queued just before the start event keeps the
    device busy until ``fn`` is wholly queued, so the events bound its
    device work only.  A timing counts only if the host finished queueing
    before the spin ended (the spin doubles until it does); None if even a
    100 ms spin did not hide it."""
    fn()
    torch.cuda.synchronize()
    spin_ms, ts = 1.0, []
    while len(ts) < iters:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        s.record()
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        a.record()
        fn()
        b.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        b.synchronize()
        if host_ms < s.elapsed_time(a):
            ts.append(a.elapsed_time(b))
        elif spin_ms >= 100:
            return None
        else:
            spin_ms *= 2
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | {smi}")
    return {"smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version, bitwise, on the card."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import ops as K, ref as R

    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    log(f"[kernels] layout C={lo.cap_index} r1={lo.r1} r2={lo.r2} "
        f"L={lo.cap_pull} cap_server={lo.cap_server}")
    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in K.KERNELS}

    def check(name, a, b, what):
        err[name] = max(err[name], same(a, b, f"{name} {what}"))

    cases = [("realistic", lo, zipf_rows(rng, n, M, SLICE["tokens"], d,
                                         torch.bfloat16, dev)),
             ("dense", lo, dense_rows(rng, n, M, 0.2, d, torch.bfloat16,
                                      dev))]
    edge = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"],
                             r2_ratio=0.001)
    cases.append(("overflow-edge", edge, cases[1][2]))
    shapes, dense = {}, {}
    for name, lay, g in cases:
        inp = kernel_inputs(g, lay)
        idx, lp, vals, bms = (inp[k] for k in ("idx", "lp", "vals", "bms"))
        seeds = lay.static_seeds()
        for nm, r2 in (("", lay.r2), ("/r2=4", 4)):
            a = K.zen_encode_fused_op(idx, seeds, n, lay.r1, r2)
            b = R.zen_encode_ref(idx, seeds, n, lay.r1, r2)
            check("zen_encode", a, b, f"{name}{nm}")
            # the fused kernel against the unfused chain's kernels
            check("zen_encode", a,
                  K.zen_encode_unfused(idx, seeds, n, lay.r1, r2),
                  f"{name}{nm} vs unfused chain")
            log(f"[kernels] zen_encode {name}{nm}: equal, and to the unfused "
                f"chain (nnz={int((idx != 2**31 - 1).sum())}, ovf={int(b[2])})")
        check("hash_stage", K.hash_stage_op(idx, seeds, n, lay.r1),
              R.hash_stage_ref(idx, seeds, n, lay.r1), name)
        check("row_compact", [K.row_compact_op(inp["mem"])],
              [R.row_compact_ref(inp["mem"])], name)
        bitmap_checks(name, inp, lay, check)
        log(f"[kernels] hash_stage, row_compact, bitmap_pack, bitmap_unpack "
            f"{name}: equal (live slots={int(inp['masks'][0].sum())}, all "
            f"servers {int(inp['masks'].sum())})")
        caps = [lay.cap_pull] + ([97] if name != "realistic" else [])
        for dtype in (torch.float32, torch.bfloat16):
            v = vals.to(dtype)
            for cname, out, sidx, sv in scatter_cases(lp, v, lay.cap_server,
                                                      rng):
                b = R.coo_scatter_add_ref(out, sidx, sv)
                # twice in a row: the kept scratch is left clean
                for call in (1, 2):
                    a = K.coo_scatter_add_op(out.clone(), sidx, sv)
                    check("coo_scatter_add", [a], [b],
                          f"{name}/{cname} {dtype} call {call}")
            for cap_pull in caps:
                a = K.zen_commit_push_fused_op(lp, v, cap_server=lay.cap_server,
                                               cap_pull=cap_pull)
                b = R.zen_commit_push_ref(lp, v, cap_server=lay.cap_server,
                                          cap_pull=cap_pull)
                what = f"{name} {dtype} cap_pull={cap_pull}"
                check("zen_commit_push", a, b, what)
                check("zen_commit_push", a, K.zen_commit_push_unfused(
                    lp, v, cap_server=lay.cap_server, cap_pull=cap_pull),
                    what + " vs unfused chain")
                log(f"[kernels] zen_commit_push {what}: equal, and to the "
                    f"unfused chain (live rows="
                    f"{int((lp < lay.cap_server).sum())}, ovf={int(b[3])})")
            log(f"[kernels] coo_scatter_add {name} {dtype}: equal, each case "
                f"twice in a row (stream, non-zero out + EMPTY/negative/"
                f"out-of-range, 64 and 4096 repeats, every row distinct)")
        for cap_pull in caps:
            a = K.zen_commit_pull_fused_op(bms, lay.cap_server, cap_pull)
            b = R.zen_commit_pull_ref(bms, lay.cap_server, cap_pull)
            check("zen_commit_pull", [a], [b], f"{name} cap_pull={cap_pull}")
            check("zen_commit_pull", [a], [K.zen_commit_pull_unfused(
                bms, lay.cap_server, cap_pull)],
                f"{name} cap_pull={cap_pull} vs unfused chain")
        log(f"[kernels] zen_commit_pull {name}: equal, and to the unfused "
            f"chain")
        if name == "realistic":
            shapes = dict(inp, lo=lay)
        elif name == "dense":
            dense = dict(idx=idx, mem=inp["mem"], lp=lp, vals=vals, lo=lay)
    # cancellation: occupied slots whose rows sum to exactly zero, and one
    # whose row is -0.0; the mask (and so the push's output) drops them
    lp = shapes["lp"]
    v, gone = cancel_values(lp, shapes["vals"], lo.cap_server)
    for dtype in (torch.float32, torch.bfloat16):
        for cap_pull in (lo.cap_pull, 97):
            a = K.zen_commit_push_fused_op(lp, v.to(dtype),
                                           cap_server=lo.cap_server,
                                           cap_pull=cap_pull)
            b = R.zen_commit_push_ref(lp, v.to(dtype),
                                      cap_server=lo.cap_server,
                                      cap_pull=cap_pull)
            what = f"cancel {dtype} cap_pull={cap_pull}"
            check("zen_commit_push", a, b, what)
            check("zen_commit_push", a, K.zen_commit_push_unfused(
                lp, v.to(dtype), cap_server=lo.cap_server, cap_pull=cap_pull),
                what + " vs unfused chain")
            kept = R.bitmap_unpack_ref(a[2])[gone]
            if kept.any():
                raise AssertionError(f"zen_commit_push {what}: a slot whose "
                                     f"rows cancel is kept")
    occupied = int(torch.unique(lp[lp < lo.cap_server]).numel())
    log(f"[kernels] zen_commit_push cancel: equal, and to the unfused chain "
        f"({occupied} occupied slots, {len(gone)} of them cancel to zero)")
    # skew: partition 0 holds far more than C / n candidates, more than a
    # shared-memory list takes, so its list goes to the global scratch
    idx, seeds = encode_skew_stream(lo, rng, dev), lo.static_seeds()
    for nm, r2 in (("", lo.r2), ("/r2=4", 4)):
        a = K.zen_encode_fused_op(idx, seeds, n, lo.r1, r2)
        b = R.zen_encode_ref(idx, seeds, n, lo.r1, r2)
        check("zen_encode", a, b, f"skew{nm}")
        check("zen_encode", a, K.zen_encode_unfused(idx, seeds, n, lo.r1, r2),
              f"skew{nm} vs unfused chain")
        log(f"[kernels] zen_encode skew{nm}: equal, and to the unfused chain "
            f"(nnz={int((idx != 2**31 - 1).sum())}, ovf={int(b[2])})")
    compact_hash_edges(lo, rng, dev, check)
    torch.cuda.synchronize()
    return {"err": err, "inputs": shapes, "dense": dense}


COMPRESS = "topk:0.01"
# the compressed path's widest buckets at n = 8: a 25 MiB bf16 bucket of
# qwen2-0.5b's ffn leaves (three [896, 4864] leaves) and its lm_head/w
WIDE = {"c": ("25 MiB ffn bucket", 13_074_432),
        "d": ("lm_head/w", 136_134_656)}


def compressed_inputs(S: int, dev, seed: int = 3) -> dict:
    """The fused kernels' inputs on the compressed path at an ``S``-element
    bucket, n = 8, ``COMPRESS`` (layout budget 4 x its density): each
    worker's seeded normal bf16 gradient EF-compressed at step 0, worker
    0's compacted index vector and its Alg. 1 memory, server 0's pushed
    stream (positions and bf16 values), every server's mask and bitmap
    (built with the plain route)."""
    from repro_torch.core import schemes as S_, sparsify as SP
    from repro_torch.core.hashing import EMPTY, compact_rows, hierarchical_hash
    from repro_torch.kernels import ref as R

    n = SLICE["n"]
    cfg = SP.parse_compress(COMPRESS)
    lo = S_.make_zen_layout(S, n, density_budget=min(1.0, 4 * cfg.density))
    gen = torch.Generator(device=dev).manual_seed(seed)
    sent = torch.empty((n, S), dtype=torch.bfloat16, device=dev)
    for w in range(n):
        g = torch.randn(S, generator=gen, device=dev).to(torch.bfloat16)
        sent[w] = SP.compress_bucket(cfg, g, None)[0]
        del g
    enc = S_.zen_encode(sent, layout=lo, backend="torch")
    idx = compact_rows(sent[:1] != 0, lo.cap_index)[0][0].contiguous()
    del sent
    grp = S_.SimGroup(n)
    got_idx = grp.all_to_all(enc.pidx).reshape(n, -1)
    got_val = grp.all_to_all(enc.pval).reshape(n, -1)
    del enc
    tab = lo.tables(dev)["local_pos"]
    live = got_idx != EMPTY
    lp = torch.where(live, tab[torch.where(live, got_idx, 0).long()],
                     lo.cap_server).to(torch.int32)
    del got_idx, live
    bms, masks = [], []
    for s_ in range(n):
        bm = R.zen_commit_push_ref(lp[s_], got_val[s_],
                                   cap_server=lo.cap_server,
                                   cap_pull=lo.cap_pull)[2]
        bms.append(bm)
        masks.append(R.bitmap_unpack_rows_ref(bm[None], lo.cap_server)[0])
    mem = hierarchical_hash(idx, n=n, r1=lo.r1, r2=lo.r2, k=lo.k,
                            seeds=lo.static_seeds()).memory
    out = dict(lo=lo, idx=idx, mem=mem, lp=lp[0].contiguous(),
               vals=got_val[0].contiguous(), bms=torch.stack(bms),
               masks=torch.stack(masks))
    del lp, got_val
    torch.cuda.empty_cache()
    return out


def wide_rows(inp: dict) -> dict:
    """(kernel call, plain call, bytes, operations) of the three fused
    kernels at a compressed bucket's inputs (``compressed_inputs``)."""
    from repro_torch.kernels import ops as K, ref as R

    lo, idx, lp, vals, bms = (inp[k] for k in ("lo", "idx", "lp", "vals",
                                                "bms"))
    n, L, seeds = lo.n, lo.cap_pull, lo.static_seeds()
    live = int((lp < lo.cap_server).sum())
    W = -(-L // 32)
    return {
        "zen_encode": (
            lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
            lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
            idx.numel() * 4 + (n * (L + W) + 1) * 4, 0),
        "zen_commit_push": (
            lambda: K.zen_commit_push_fused_op(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lambda: R.zen_commit_push_ref(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lp.numel() * 4 + live * 2 + L * (4 + 2)
            + lo.cap_bitmap_words * 4 + 4, live),
        "zen_commit_pull": (
            lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
            lambda: R.zen_commit_pull_ref(bms, lo.cap_server, L),
            bms.numel() * 4 + n * L * 4, 0)}


def phase_kernels_wide(dev, smi: str, timed: bool) -> dict:
    """The three fused Zen kernels at the compressed path's widest shapes
    (rows 1c-3c: a 25 MiB bucket; 1d-3d: lm_head/w), bitwise against their
    plain versions (the push in f32 and bf16, twice in a row), on their
    wide paths, while the slice shapes stay on the shared-memory paths; at
    the 25 MiB bucket also the unfused chain's five kernels.  With
    ``timed``, each fused kernel's time, device time and bound."""
    from repro_torch.core import schemes as S_
    from repro_torch.kernels import ops as K, ref as R

    err = {k: 0.0 for k in K.KERNELS}

    def check(name, a, b, what):
        err[name] = max(err[name], same(a, b, f"{name} {what}"))

    slice_lo = S_.make_zen_layout(SLICE["M"], SLICE["n"],
                                  density_budget=SLICE["density_budget"])
    narrow = K.zen_fused_wide(slice_lo.n, slice_lo.cap_index, slice_lo.r1,
                              slice_lo.r2, slice_lo.cap_server)
    if any(narrow.values()):
        raise AssertionError(f"a slice-shape kernel left shared memory: "
                             f"{narrow}")
    rows = []
    for tag, (what, S) in WIDE.items():
        t0 = time.time()
        inp = compressed_inputs(S, dev)
        lo = inp["lo"]
        wide = K.zen_fused_wide(lo.n, lo.cap_index, lo.r1, lo.r2,
                                lo.cap_server)
        log(f"[kernels_wide] {tag} {what} S={S}: C={lo.cap_index} "
            f"r1+r2={lo.cap_pull} cap_server={lo.cap_server} push stream "
            f"{inp['lp'].numel()} rows, {int((inp['lp'] < lo.cap_server).sum())}"
            f" live; wide paths {wide} (inputs {time.time() - t0:.1f}s)")
        if not all(wide.values()):
            raise AssertionError(f"{what}: a fused kernel stayed on its "
                                 f"shared-memory path: {wide}")
        calls = wide_rows(inp)
        for name, (kern, plain, _, _) in calls.items():
            want = plain()
            for call in (1, 2):   # the kept scratch is left clean
                check(name, kern(), want, f"{tag} {what} call {call}")
        lp, vals = inp["lp"], inp["vals"]
        v32 = vals.float()
        check("zen_commit_push",
              K.zen_commit_push_fused_op(lp, v32, cap_server=lo.cap_server,
                                         cap_pull=lo.cap_pull),
              R.zen_commit_push_ref(lp, v32, cap_server=lo.cap_server,
                                    cap_pull=lo.cap_pull), f"{tag} f32")
        log(f"[kernels_wide] {tag}: zen_encode, zen_commit_push (bf16, f32) "
            f"and zen_commit_pull equal their plain versions")
        if tag == "c":   # the unfused chain's kernels at the 25 MiB bucket
            seeds, idx = lo.static_seeds(), inp["idx"]
            check("hash_stage", K.hash_stage_op(idx, seeds, lo.n, lo.r1),
                  R.hash_stage_ref(idx, seeds, lo.n, lo.r1), tag)
            check("row_compact", [K.row_compact_op(inp["mem"])],
                  [R.row_compact_ref(inp["mem"])], tag)
            zeros = torch.zeros((lo.cap_server, 1), dtype=vals.dtype,
                                device=dev)
            check("coo_scatter_add",
                  [K.coo_scatter_add_op(zeros.clone(), lp, vals[:, None])],
                  [R.coo_scatter_add_ref(zeros, lp, vals[:, None])], tag)
            check("bitmap_pack", [K.bitmap_pack_rows_op(inp["masks"])],
                  [R.bitmap_pack_rows_ref(inp["masks"])], tag)
            check("bitmap_unpack",
                  [K.bitmap_unpack_rows_op(inp["bms"], lo.cap_server)],
                  [R.bitmap_unpack_rows_ref(inp["bms"], lo.cap_server)], tag)
            log(f"[kernels_wide] {tag}: hash_stage, row_compact, "
                f"coo_scatter_add, bitmap_pack, bitmap_unpack equal their "
                f"plain versions")
        if timed:
            for name, (kern, plain, nbytes, nops) in calls.items():
                row = time_row(f"{name} ({what})", kern, plain, None, nbytes,
                               nops, OPS_PER_S, smi, plain_iters=3)
                rows.append({**row, "kernel": name, "row": tag})
            launch_split(calls["zen_commit_pull"][0],
                         f"zen_commit_pull ({what})")
        del inp, calls
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"err": err, "rows": rows}


# the new shapes of the two-level and zoo paths: (tag, what, vocab, d, n,
# ranks whose Zipf rows one node sums (1: a rank's own rows), layout budget)
NEW_SHAPES = (("e", "inter stage, nodes of 4 (n 2, budget 1)", 151936, 896,
               2, 4, 1.0),
              ("f", "qwen2.5-3b embed/table (n 2)", 151936, 2048, 2, 1,
               0.25),
              ("g", "phi4-mini embed/table (n 2)", 200064, 3072, 2, 1, 0.25),
              ("h", "zamba2-1.2b embed/table (n 2)", 32000, 2048, 2, 1,
               0.25),
              ("i", "olmoe-1b-7b embed/table (n 2)", 50304, 2048, 2, 1,
               0.25),
              ("j", "phi3.5-moe embed/table (n 2)", 32064, 4096, 2, 1,
               0.25))


def zen_rows(inp: dict, lo, d: int) -> dict:
    """(kernel call, plain call, bytes, operations) of the three fused Zen
    kernels at ``kernel_inputs``' worker 0 / server 0, at row width ``d``
    (bf16), counted as the table's rows 1-3."""
    from repro_torch.kernels import ops as K, ref as R

    idx, lp, vals, bms = (inp[k] for k in ("idx", "lp", "vals", "bms"))
    n, L, seeds = lo.n, lo.cap_pull, lo.static_seeds()
    live = int((lp < lo.cap_server).sum())
    W, el = -(-L // 32), vals.element_size()
    return {
        "zen_encode": (
            lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
            lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
            idx.numel() * 4 + (n * (L + W) + 1) * 4, 0),
        "zen_commit_push": (
            lambda: K.zen_commit_push_fused_op(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lambda: R.zen_commit_push_ref(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lp.numel() * 4 + live * d * el + L * (4 + d * el)
            + lo.cap_bitmap_words * 4 + 4, live * d),
        "zen_commit_pull": (
            lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
            lambda: R.zen_commit_pull_ref(bms, lo.cap_server, L),
            bms.numel() * 4 + n * L * 4, 0)}


def phase_new_shapes(dev, smi: str, timed: bool) -> dict:
    """The fused Zen kernels at the shapes this slice's paths give them
    (``NEW_SHAPES``): the inter stage of nodes of 4 (2 servers, budget 1:
    the encode on its wide path at d 896) and the zoo trainers' embedding
    tables at d 2048 and 3072 (2 ranks): bitwise their plain versions,
    twice in a row; with ``timed`` each kernel's time and bound (rows 1e,
    2f-g, 3f-g and the rest beside them)."""
    from repro_torch.core import schemes as S_
    from repro_torch.kernels import ops as K

    err = {k: 0.0 for k in K.KERNELS}
    rows = []
    rng = np.random.default_rng(7)
    for tag, what, M, d, n, per_node, budget in NEW_SHAPES:
        g = zipf_rows(rng, n * per_node, M, SLICE["tokens"], d,
                      torch.bfloat16, dev)
        if per_node > 1:   # each node's sum of its ranks' rows
            g = g.view(n, per_node, M, d).sum(1, dtype=torch.float32).to(
                torch.bfloat16)
        lo = S_.make_zen_layout(M, n, density_budget=budget)
        inp = kernel_inputs(g, lo)
        del g
        wide = K.zen_fused_wide(lo.n, lo.cap_index, lo.r1, lo.r2,
                                lo.cap_server)
        log(f"[new_shapes] {tag} {what}: M={M} d={d} C={lo.cap_index} "
            f"r1+r2={lo.cap_pull} cap_server={lo.cap_server}; worker 0 "
            f"{int((inp['idx'] != 2**31 - 1).sum())} live rows, server 0 "
            f"{int((inp['lp'] < lo.cap_server).sum())} pushed; wide paths "
            f"{wide}")
        if tag == "e" and not wide["zen_encode"]:
            raise AssertionError("the inter stage's encode stayed on its "
                                 "shared-memory path")
        calls = zen_rows(inp, lo, d)
        for name, (kern, plain, _, _) in calls.items():
            want = plain()
            for call in (1, 2):
                err[name] = max(err[name], same(
                    kern(), want, f"{name} {tag} {what} call {call}"))
        log(f"[new_shapes] {tag}: zen_encode, zen_commit_push and "
            f"zen_commit_pull equal their plain versions")
        if timed:
            for name, (kern, plain, nbytes, nops) in calls.items():
                row = time_row(f"{name} ({what}, d {d})", kern, plain, None,
                               nbytes, nops, OPS_PER_S, smi, plain_iters=5)
                rows.append({**row, "kernel": name, "row": tag})
        del inp, calls
        torch.cuda.empty_cache()
    return {"err": err, "rows": rows}


def bitmap_checks(name: str, inp: dict, lo, check) -> None:
    """The bitmap pair in its row and 1-D forms against the plain versions,
    bitwise: every server's mask [n, cap_server] (the unfused commit's one
    pack a sync), worker 0's encode occupancy [n, r1 + r2], the gathered
    bitmaps unpacked into [n, cap_server] (the pull) and whole, rows cut
    to ragged lengths of 1-33 bits and cap_server - 5, and all-zero /
    all-one masks and words."""
    from repro_torch.kernels import ops as K, ref as R

    masks, occ, bms = inp["masks"], inp["occ"], inp["bms"]
    cases = [(f"occ {tuple(occ.shape)}", occ)]
    for L in (lo.cap_server, lo.cap_server - 5, 33, 32, 31, 1):
        cases.append((f"masks [n, {L}]", masks[:, :L].contiguous()))
    cases += [("zeros", torch.zeros_like(masks)),
              ("ones", torch.ones_like(masks))]
    for what, m in cases:
        want = R.bitmap_pack_rows_ref(m)
        check("bitmap_pack", [K.bitmap_pack_rows_op(m)], [want],
              f"{name} {what}")
        check("bitmap_pack", [K.bitmap_pack_op(m[1])], [want[1]],
              f"{name} {what} row 1 alone")
    Wb = bms.shape[1]
    words = [("bms", bms), ("zeros", torch.zeros_like(bms)),
             ("ones", torch.full_like(bms, -1))]
    for what, w in words:
        for length in (lo.cap_server, 32 * Wb, 32 * Wb - 33, 33, 1):
            want = R.bitmap_unpack_rows_ref(w, length)
            check("bitmap_unpack", [K.bitmap_unpack_rows_op(w, length)],
                  [want], f"{name} {what} length={length}")
            check("bitmap_unpack", [K.bitmap_unpack_op(w[1], length)],
                  [want[1]], f"{name} {what} row 1 alone length={length}")
    flat = bms.reshape(-1)
    check("bitmap_unpack", [K.bitmap_unpack_op(flat, flat.numel() * 32)],
          [R.bitmap_unpack_ref(flat) != 0], f"{name} all words as one row")


def compact_hash_edges(lo, rng, dev, check) -> None:
    """``row_compact`` and ``hash_stage`` at their kernels' edges, bitwise
    against their plain versions: rows of 1, 3 and 129 slots, rows past
    one tile a block (8 x 1536 slots), one row, all-EMPTY / all-live /
    live-only-at-the-end rows and an input 4 bytes off a 16-byte boundary
    (rows of the slice's r1 + r2); index vectors of 0-37 entries and of the
    slice's C + 3 (not a multiple of four), k = 1 and 15, n = r1 = 1, all
    EMPTY, seeds with the top bit set and unaligned indices."""
    from repro_torch.core.hashing import EMPTY
    from repro_torch.kernels import ops as K, ref as R

    def ids(shape, density):
        """Unique ids, EMPTY where a draw is >= ``density``."""
        x = rng.choice(1 << 30, int(np.prod(shape)), replace=False)
        x[rng.random(x.size) >= density] = EMPTY
        return torch.as_tensor(x.reshape(shape), dtype=torch.int32,
                               device=dev)

    def off16(t):
        """The same values in a view 4 bytes into its storage."""
        flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
        return flat[1:].view(t.shape)

    L = lo.cap_pull
    mems = {f"L={w}": ids((r, w), dn) for w, r, dn in (
        (1, 8, 0.5), (3, 8, 0.5), (129, 8, 0.5), (16385, 3, 0.3),
        (40000, 3, 0.3))}
    mems["R=1"] = ids((1, L), 0.003)
    rows = ids((4, L), 0.5)
    rows[0] = EMPTY                                   # all EMPTY
    rows[1] = ids((L,), 1.0)                          # all live
    rows[2, :-9] = EMPTY                              # live only at the end
    rows[2, -9:] = ids((9,), 1.0)
    mems["empty/live/end rows"] = rows
    mems["unaligned"] = off16(ids((8, L), 0.36))
    for name, mem in mems.items():
        check("row_compact", [K.row_compact_op(mem)],
              [R.row_compact_ref(mem)], f"edge {name}")
    C, n, r1 = lo.cap_index + 3, lo.n, lo.r1
    top = [int(x) for x in rng.integers(2**31, 2**32, 4, dtype=np.uint64)]
    seeds = {k: [int(x) for x in rng.integers(0, 2**32, k + 1,
                                              dtype=np.uint64)]
             for k in (1, 3, 15)}
    cases = [(f"C={c}", ids((c,), 0.7), seeds[3], n, r1)
             for c in (0, 1, 3, 37, C)]
    cases += [(f"k={k}", ids((C,), 0.7), seeds[k], n, r1) for k in (1, 15)]
    cases += [("n=r1=1", ids((C,), 0.7), seeds[3], 1, 1),
              ("all EMPTY", ids((C,), 0.0), seeds[3], n, r1),
              ("top-bit seeds", ids((C,), 0.7), top, n, r1),
              ("unaligned", off16(ids((C,), 0.7)), seeds[3], n, r1)]
    for name, idx, sd, nn, rr in cases:
        check("hash_stage", K.hash_stage_op(idx, sd, nn, rr),
              R.hash_stage_ref(idx, sd, nn, rr), f"edge {name}")
    log(f"[kernels] row_compact edges equal ({', '.join(mems)}); hash_stage "
        f"edges equal ({', '.join(c[0] for c in cases)})")


def cancel_values(lp: torch.Tensor, vals: torch.Tensor, cap_server: int):
    """Integer values (exact in bf16) for server 0's stream ``lp`` in which
    every other slot that gets two or more rows has its second row the
    negative of its first and any later rows zero, so its sum is exactly
    +0.0, and one slot's rows are -0.0.  Returns (vals f32, the slots whose
    sum is zero)."""
    lpn = lp.cpu().numpy()
    v = torch.round(vals.float().cpu() * 8)
    live = np.flatnonzero(lpn < cap_server)
    rows = {}
    for r in live:                         # stream order within a slot
        rows.setdefault(int(lpn[r]), []).append(int(r))
    multi = [s for s, rs in sorted(rows.items()) if len(rs) >= 2]
    gone = multi[::2]
    for s in gone:
        first, second, *rest = rows[s]
        v[second] = -v[first]
        v[rest] = 0.0
    neg0 = next(s for s, rs in sorted(rows.items()) if s not in gone)
    v[rows[neg0]] = -0.0
    return v.to(vals.device), torch.as_tensor(gone + [neg0], device=lp.device)


def encode_skew_stream(lo, rng, dev) -> torch.Tensor:
    """An index vector of C = cap_index entries in which partition 0 takes
    12000 ids (3x the dense stream's share, past the kernel's 4096-entry
    shared-memory list) and the others 2000 each, with EMPTY entries
    scattered through it: ascending ids, as the compaction gives them."""
    from repro_torch.core.hashing import EMPTY, hash_u32

    ids = torch.arange(SLICE["M"], dtype=torch.int32)
    part = hash_u32(ids, lo.static_seeds()[0]) % lo.n
    picks = [ids[part == p][torch.as_tensor(rng.permutation(
        int((part == p).sum()))[:12000 if p == 0 else 2000])]
        for p in range(lo.n)]
    live = torch.sort(torch.cat(picks)).values
    C = lo.cap_index
    slots = torch.as_tensor(np.sort(rng.choice(C, live.numel(),
                                               replace=False)))
    idx = torch.full((C,), EMPTY, dtype=torch.int32)
    idx[slots] = live
    return idx.to(dev)


def phase_zen_sync(dev) -> None:
    """zen_sync through the kernels == through the plain versions."""
    from repro_torch.core import schemes as S

    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    g = zipf_rows(np.random.default_rng(1), n, M, SLICE["tokens"], d,
                  torch.bfloat16, dev)
    a_out, a_st = S.simulate(S.zen_sync, g, layout=lo, backend="cuda")
    b_out, b_st = S.simulate(S.zen_sync, g, layout=lo, backend="torch")
    same([a_out, a_st.sent_words, a_st.overflow],
         [b_out, b_st.sent_words, b_st.overflow], "zen_sync cuda vs torch")
    for fe, fc in ((False, True), (True, False), (False, False)):
        for backend in ("cuda", "torch"):
            c_out, c_st = S.simulate(S.zen_sync, g, layout=lo,
                                     backend=backend, fused=fe,
                                     fused_commit=fc)
            same([c_out, c_st.sent_words, c_st.overflow],
                 [a_out, a_st.sent_words, a_st.overflow],
                 f"zen_sync {backend} fused={fe} fused_commit={fc} vs "
                 f"fused cuda")
            del c_out
        log(f"[zen_sync] fused={fe} fused_commit={fc}: cuda and torch equal "
            f"the fused cuda route bitwise")
    # and the sum every worker receives is the psum of the inputs
    ref = g.float().sum(0)
    if not torch.allclose(a_out[0].float(), ref, atol=0.1, rtol=0.02):
        raise AssertionError("zen_sync output is not the sum of the inputs")
    log(f"[zen_sync] cuda == torch bitwise; sent_words[0]="
        f"{float(a_st.sent_words[0])} overflow={a_st.overflow.tolist()}")
    del g, a_out, b_out


def phase_trainer(steps: int = 4) -> dict:
    from repro_torch.kernels import ops as K
    from repro_torch.launch import train

    argv = qwen_argv(8, steps)
    K.reset_counts()
    res = train.main(argv)
    launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    losses = res["losses"]
    log(f"[trainer] losses={losses} tok/s={res['tok_per_s']} "
        f"sparse_words={res['sparse_words']} overflow={res['overflow']} "
        f"step_s={res['step_s']} launches={launches} plain={plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"trainer loss not finite and falling: {losses}")
    if res["overflow"] != 0:
        raise AssertionError(f"trainer overflow {res['overflow']}")
    check_launches("trainer", launches, plain,
                   {k: steps * v for k, v in K.path_launches(8).items()})
    # the same run through the plain versions: the sync is bitwise equal,
    # so the losses may differ only by run-to-run noise of the model's own
    # CUDA ops
    plain_res = train.main(argv + ["--backend", "torch"])
    diff = max(abs(a - b) for a, b in zip(losses, plain_res["losses"]))
    log(f"[trainer] plain-route losses={plain_res['losses']} max |diff|="
        f"{diff} tok/s={plain_res['tok_per_s']}")
    if diff > 5e-3:
        raise AssertionError(f"kernel and plain routes diverge: {diff}")
    torch.cuda.empty_cache()
    unf = train_unfused(steps)
    udiff = max(abs(a - b) for a, b in zip(losses, unf["losses"]))
    log(f"[trainer] unfused chain: losses={unf['losses']} max |diff| vs "
        f"fused={udiff} sparse_words={unf['words']} overflow={unf['overflow']}"
        f" tok/s={unf['tok_per_s']} step_s={unf['step_s']} launches="
        f"{unf['launches']} plain={unf['plain']}")
    log(f"[trainer] median step s after the first: fused "
        f"{np.median(res['step_s'][1:])}, plain route "
        f"{np.median(plain_res['step_s'][1:])}, unfused chain "
        f"{np.median(unf['step_s'][1:])}")
    if not all(np.isfinite(unf["losses"])) \
            or not unf["losses"][-1] < unf["losses"][0]:
        raise AssertionError(f"unfused trainer loss not finite and falling: "
                             f"{unf['losses']}")
    if max(unf["overflow"]) != 0:
        raise AssertionError(f"unfused trainer overflow {unf['overflow']}")
    if unf["words"][-1] != res["sparse_words"]:
        raise AssertionError(f"unfused sparse words {unf['words'][-1]} != "
                             f"fused {res['sparse_words']}")
    if udiff > 5e-3:
        raise AssertionError(f"unfused and fused routes diverge: {udiff}")
    on_path = K.path_launches(8, **UNFUSED)   # bitmap_pack once a sync
    check_launches("unfused run", unf["launches"], unf["plain"],
                   {k: steps * v for k, v in on_path.items()})
    for k in on_path:
        launches[k] = unf["launches"][k]
    return {**res, "launches": launches, "plain_route": plain_res,
            "unfused": unf}


def train_unfused(steps: int) -> dict:
    """The smoke trainer (``launch/train.py``'s flags and SyntheticLM
    batches) with ``SyncConfig(fused_encode=False, fused_commit=False)``,
    built through ``build_program`` + ``attach_train``: the launcher has
    no flag for the unfused encode, as the reference's has none."""
    from repro_torch.configs import get_config
    from repro_torch.core.zen import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops as K
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    cfg = get_config("qwen2-0.5b")
    tcfg = TrainerConfig(opt=OptConfig(lr=3e-4),
                         sync=SyncConfig(scheme="zen", density_budget=0.25,
                                         **UNFUSED))
    prog = build_program(cfg, "8x1", tcfg, device="cuda", seed=0)
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8, seed=0)))
    losses, words, ovf, step_s = [], [], [], []
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.time()
    for _ in range(steps):   # timed as launch/train.py times a logged step
        b = next(data)
        t_step = time.time()
        m = prog.train_step({k: torch.as_tensor(v, device="cuda").long()
                             for k, v in b.items()})
        torch.cuda.synchronize()
        step_s.append(time.time() - t_step)
        losses.append(float(m["loss"]))
        words.append(float(m["sync/sparse_sent_words"]))
        ovf.append(int(float(m["sync/overflow"])))
    dt = time.time() - t0
    out = {"losses": losses, "words": words, "overflow": ovf,
           "launches": dict(K.LAUNCHES), "plain": dict(K.PLAIN_CALLS),
           "tok_per_s": steps * 8 * 512 / dt, "step_s": step_s}
    del prog
    torch.cuda.empty_cache()
    return out


def _kernel_category(name: str) -> str:
    if "zen_" in name:        # the Zen kernels in csrc/ are named zen_*_kernel
        return "zen kernels"
    if "flash_fwd" in name or "ssd_fwd" in name:
        return "model kernels"
    if any(g in name.lower() for g in ("gemm", "xmma", "cutlass", "cublas",
                                       "nvjet")):
        return "matmul"
    return "other"


def device_breakdown(run, tag: str) -> dict:
    """Run ``run()`` once under torch.profiler: wall ms (host clock to a
    device sync), device ms by kernel category, and the device's idle
    share; logs the ten largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats: dict[str, float] = {}
    names: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            c = _kernel_category(e.name)
            cats[c] = cats.get(c, 0.0) + ms
            names[e.name] = names.get(e.name, 0.0) + ms
    busy = sum(cats.values())
    out = {"wall_ms": wall_ms, "device_ms": cats, "busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "by_name": names}
    log(f"[{tag}] wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {out['idle_share']}), by category "
        f"{ {k: round(v, 3) for k, v in cats.items()} }")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[{tag}]   {ms:9.3f} ms  {name[:110]}")
    return out


def phase_breakdown(steps: int = 2) -> dict:
    """Device time of one trainer step (the smoke config) by kernel
    category, from torch.profiler, and the device's idle share."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program

    torch.cuda.empty_cache()
    cfg = get_config("qwen2-0.5b")
    prog = build_program(cfg, "8x1", device="cuda")
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8)))

    def batch():
        return {k: torch.as_tensor(v, device="cuda").long()
                for k, v in next(data).items()}

    for _ in range(steps - 1):            # warm-up
        prog.train_step(batch())
    b = batch()
    out = device_breakdown(lambda: prog.train_step(b), "breakdown")
    del prog
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the bucketed, overlapped GradSync
# ---------------------------------------------------------------------------

BUCKET_BYTES = 26_214_400   # 25 MiB: PyTorch DDP's default bucket_cap_mb
OVERLAP_REPEATS = 5


def qwen_argv(n: int, steps: int, *extra: str) -> list[str]:
    """``launch/train.py``'s flags for the qwen2-0.5b smoke trainer on an
    ``n`` x 1 mesh: Zen, global batch 8 x 512 tokens."""
    return ["--arch", "qwen2-0.5b", "--mesh", f"{n}x1", "--sync", "zen",
            "--global-batch", "8", "--seq-len", "512", "--steps", str(steps),
            "--log-every", "1", *extra]


def check_launches(tag: str, launches: dict, plain: dict,
                   want: dict) -> None:
    """Every kernel launched ``want[k]`` times (0 if absent), none plain."""
    from repro_torch.kernels import ops as K

    for k in K.KERNELS:
        if launches[k] != want.get(k, 0) or plain[k]:
            raise AssertionError(f"{tag}: {k} launched {launches[k]} times "
                                 f"(expected {want.get(k, 0)}), plain "
                                 f"{plain[k]}")


def plan_summary(buckets: list[dict]) -> str:
    """The launcher's bucket plan by (kind, dtype): count, bytes, leaves."""
    groups: dict[tuple, list] = {}
    for b in buckets:
        groups.setdefault((b["kind"], b["dtype"]), []).append(b)
    return "; ".join(
        f"{len(bs)} {kind} {dt} ({min(b['nbytes'] for b in bs)}-"
        f"{max(b['nbytes'] for b in bs)} B, "
        f"{sum(b['leaves'] for b in bs)} leaves)"
        for (kind, dt), bs in sorted(groups.items()))


def phase_buckets(smi: str, steps: int = 4) -> dict:
    """The in-process 8x1 trainer with 25 MiB dense buckets beside the
    one-bucket-a-leaf trainer: losses, grad norm, wire words and overflow
    bitwise equal, Zen's kernels 8 x steps times each, nothing plain."""
    from repro_torch.kernels import ops as K
    from repro_torch.launch import train

    runs, launches = {}, {}
    for tag, extra in (("per-leaf", ()),
                       ("bucketed", ("--bucket-bytes", str(BUCKET_BYTES)))):
        torch.cuda.empty_cache()
        K.reset_counts()
        res = train.main(qwen_argv(8, steps, *extra))
        launches = dict(K.LAUNCHES)
        check_launches(f"buckets {tag}", launches, K.PLAIN_CALLS,
                       {k: steps * v for k, v in K.path_launches(8).items()})
        runs[tag] = res
        log(f"[buckets] {tag}: {len(res['buckets'])} buckets: "
            f"{plan_summary(res['buckets'])}")
        log(f"[buckets] {tag}: losses={res['losses']} grad_norm="
            f"{res['grad_norm']} sparse_words={res['sparse_words_by_step']} "
            f"dense_words={res['dense_words']} overflow={res['overflow']} "
            f"step_s={res['step_s']} tok/s={res['tok_per_s']}")
    a, b = runs["per-leaf"], runs["bucketed"]
    for key in ("losses", "grad_norm", "sparse_words_by_step",
                "dense_words", "overflow"):
        if a[key] != b[key]:
            raise AssertionError(f"bucketed trainer's {key} {b[key]} != "
                                 f"per-leaf {a[key]}")
    if a["overflow"] != 0:
        raise AssertionError(f"trainer overflow {a['overflow']}")
    log(f"[buckets] 8x1 in-process, per-leaf vs 25 MiB buckets: losses, "
        f"grad norm, wire words and overflow bitwise equal; median step s "
        f"after the first {np.median(a['step_s'][1:])} vs "
        f"{np.median(b['step_s'][1:])}; tok/s {a['tok_per_s']} vs "
        f"{b['tok_per_s']} | {smi}")
    return {"launches": launches}


def compress_program(scheme: str = "zen", backend: str = "cuda"):
    """The qwen2-0.5b 8x1 trainer at full width and depth with 25 MiB
    buckets and ``--compress COMPRESS``, built through ``build_program`` +
    ``attach_train`` (as ``launch/train.py --sync SCHEME --compress
    COMPRESS --bucket-bytes 26214400`` builds it), so the EF residuals in
    its optimizer state can be read."""
    from repro_torch.configs import get_config
    from repro_torch.core.zen import SyncConfig
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    tcfg = TrainerConfig(opt=OptConfig(lr=3e-4), sync=SyncConfig(
        scheme=scheme, density_budget=0.25, bucket_bytes=BUCKET_BYTES,
        compress=COMPRESS, backend=backend))
    prog = build_program(get_config("qwen2-0.5b"), "8x1", tcfg,
                         device="cuda", seed=0, backend=backend)
    attach_train(prog)
    return prog


def residual_digest(res: dict) -> str:
    """A digest of the EF residuals' bits, taken on the card: per rank row,
    the wrapping int64 sums of the f32 words and of the words times a
    position hash, then sha256 of those sums."""
    sums = []
    for k in sorted(res):
        r = res[k]
        for w in range(r.shape[0]):
            x = r[w].view(torch.int32)
            for a in range(0, x.numel(), 1 << 24):
                c = x[a:a + (1 << 24)].long()
                pos = torch.arange(a, a + c.numel(), device=c.device)
                sums += [c.sum(), (c * (pos * 2654435761 % 4294967291
                                        + 1)).sum()]
    return hashlib.sha256(json.dumps(torch.stack(sums).tolist())
                          .encode()).hexdigest()


SMALL_BUCKET = 4096   # elements: the f32 norm-scale buckets (896 each)


def step0_checks(prog, batch: dict) -> dict:
    """On the step-0 gradients of every rank, for every compressed bucket:
    the EF invariant bitwise (``sent + r' == payload + r`` in f32 from a
    zero residual) and Zen on the sent payload (the fused kernels) against
    its psum: every element within the summation bound ``(n - 1) u sum_w
    |sent_w|``, or zero where Zen's capacity dropped a slot (no more such
    elements than the bucket's overflow count).  Overflow is allowed only
    in buckets of at most SMALL_BUCKET elements, whose r1 + r2 of 13 slots
    a server the union of 8 ranks' top-9 sets can pass (the reference's
    provisioning, which the port keeps)."""
    from repro_torch.core import buckets as bk
    from repro_torch.core import schemes as S_
    from repro_torch.train.steps import split_batch

    gs, model, n = prog.gradsync, prog.model, prog.n_data
    leaves = model.named_leaves()
    stacks = {nm: torch.empty((n, *p.shape), dtype=p.dtype, device=p.device)
              for nm, p in leaves}
    for w, b in enumerate(split_batch(batch, n)):
        model.zero_grad(set_to_none=True)
        model(b["tokens"], b["labels"]).backward()
        for nm, p in leaves:
            if p.grad is None:
                stacks[nm][w].zero_()
            else:
                stacks[nm][w].copy_(p.grad)
    model.zero_grad(set_to_none=True)
    flat = [stacks[nm] for nm in gs.names]
    worst, checked, over = 0.0, 0, {}
    for b in gs.plan.buckets:
        if b.compress == "none":
            continue
        payload = bk.gather_bucket(b, flat)
        zero = torch.zeros(payload.shape, dtype=torch.float32,
                           device=payload.device)
        sent, r, _ = gs.compress_payload(b, payload, zero, step=0)
        if not torch.equal(bits(sent.float() + r), bits(payload.float()
                                                        + zero)):
            raise AssertionError(f"EF invariant broken in bucket {b.bid} "
                                 f"({b.key})")
        z, st = S_.simulate(S_.zen_sync, sent, layout=gs._layouts[b.key, 0],
                            backend="cuda")
        d, _ = S_.simulate(S_.dense_sync, sent)
        u = 2.0 ** (-8 if sent.dtype == torch.bfloat16 else -24)
        lim = (n - 1) * u * sent.float().abs().sum(0)
        diff = (z[0].float() - d[0].float()).abs()
        lost = (z[0] == 0) & (d[0] != 0)
        ovf = int(st.overflow.sum())
        if bool((~lost & (diff > lim)).any()) or int(lost.sum()) > ovf:
            raise AssertionError(f"compressed zen vs dense in bucket {b.bid} "
                                 f"({b.key}): over the sum bound, or "
                                 f"{int(lost.sum())} elements lost for "
                                 f"overflow {ovf}")
        if ovf:
            over[b.key] = (b.size, ovf, int(lost.sum()))
        worst = max(worst, float((diff * ~lost).max()))
        checked += 1
        del payload, zero, sent, r, z, d, diff, lim, lost
    del stacks, flat
    torch.cuda.empty_cache()
    big = {k: v for k, v in over.items() if v[0] > SMALL_BUCKET}
    log(f"[compress] step 0, {checked} compressed buckets: EF invariant "
        f"bitwise; zen on the sent payloads vs their psum max |diff| "
        f"{worst} where kept (bound (n - 1) u sum|x|); overflow in "
        f"{len(over)} buckets (key: size, overflow, elements lost): {over}")
    if big:
        raise AssertionError(f"compressed zen overflows in buckets past "
                             f"{SMALL_BUCKET} elements: {big}")
    return {"buckets": checked, "zen_vs_dense_max_diff": worst,
            "overflow_buckets": over}


def compress_steps(prog, batches: list, tag: str) -> dict:
    """Train ``prog`` on ``batches`` (one step each), timed as
    ``launch/train.py`` times a logged step: losses, words, overflow, grad
    norms, step times and the residual digest after each step."""
    out = {k: [] for k in ("losses", "words", "dense_words", "overflow",
                           "grad_norm", "step_s", "digest")}
    torch.cuda.synchronize()
    t0 = time.time()
    for b in batches:
        t = time.time()
        m = prog.train_step(b)
        torch.cuda.synchronize()
        out["step_s"].append(time.time() - t)
        out["losses"].append(float(m["loss"]))
        out["words"].append(float(m["sync/sparse_sent_words"]))
        out["dense_words"].append(float(m["sync/dense_words"]))
        out["overflow"].append(int(float(m["sync/overflow"])))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["digest"].append(residual_digest(prog.opt_state()["residual"]))
    out["tok_per_s"] = len(batches) * 8 * 512 / (time.time() - t0)
    log(f"[compress] {tag}: losses={out['losses']} words={out['words']} "
        f"dense_words={out['dense_words']} overflow={out['overflow']} "
        f"grad_norm={out['grad_norm']} step_s={out['step_s']} "
        f"tok/s={out['tok_per_s']} digests={[d[:12] for d in out['digest']]}")
    return out


def phase_compress(smi: str, steps: int = 4, plain_steps: int = 1) -> dict:
    """EF compression on the full-width qwen2-0.5b 8x1 trainer with 25 MiB
    buckets: ``--sync zen --compress topk:0.01`` on the kernels (98
    compressed dense buckets and the embedding, all on Zen's fused kernels,
    ``steps`` steps, counts from 0 around them), against its plain route
    (``--backend torch``, ``plain_steps`` steps: losses, words and residual
    digests bitwise) and ``--sync dense --compress topk:0.01`` (1 step: the
    same residual digest); the step-0 EF invariant and Zen-vs-psum of each
    bucket; step time, tok/s, peak memory, one profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops as K

    torch.cuda.empty_cache()
    data = iter(SyntheticLM(get_config("qwen2-0.5b"),
                            DataConfig(seq_len=512, batch=8, seed=0)))
    batches = [{k: torch.as_tensor(v, device="cuda").long()
                for k, v in next(data).items()} for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prog = compress_program()
    gs = prog.gradsync
    plan = gs.plan.buckets
    comp = [b for b in plan if b.compress != "none"]
    log(f"[compress] plan: {len(plan)} buckets, {len(comp)} compressed "
        f"({COMPRESS}), schemes {sorted({b.scheme for b in plan})}, "
        f"{len(gs._layouts)} zen layouts; compressed elements "
        f"{sum(b.size for b in comp)}, largest {max(b.size for b in comp)}; "
        f"built in {time.time() - t0:.1f}s")
    if len(plan) != 99 or len(comp) != 98 or len(gs._layouts) != 99 \
            or any(b.scheme != "zen" for b in plan):
        raise AssertionError("compressed plan is not 98 compressed zen "
                             "buckets and the zen embedding")
    checks = step0_checks(prog, batches[0])
    K.reset_counts()
    run = compress_steps(prog, batches, "zen, kernels")
    launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("compress", launches, plain,
                   {k: steps * 8 * len(gs._layouts)
                    for k in K.path_kernels()})
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"compressed trainer: losses {run['losses']}")
    dense_total = sum(b.size for b in comp)
    dense_words = 2 * 7 / 8 * dense_total
    share = max(run["words"]) / dense_words
    if share >= 0.10 or max(run["dense_words"]):
        raise AssertionError(f"compressed zen words {run['words']} are "
                             f"{share:.3f} of the dense {dense_words}")
    prof = device_breakdown(lambda: prog.train_step(batches[0]), "compress")
    zen_ms = {k: v for k, v in prof["by_name"].items() if "zen_" in k}
    log(f"[compress] profiled step: zen kernels {zen_ms}")
    del prog, gs
    torch.cuda.empty_cache()
    prog = compress_program(backend="torch")
    plain_run = compress_steps(prog, batches[:plain_steps], "zen, plain")
    del prog
    torch.cuda.empty_cache()
    for k in ("losses", "words", "overflow", "digest"):
        if plain_run[k] != run[k][:plain_steps]:
            raise AssertionError(f"compressed trainer: plain route {k} "
                                 f"{plain_run[k]} != kernels "
                                 f"{run[k][:plain_steps]}")
    prog = compress_program(scheme="dense")
    dense_run = compress_steps(prog, batches[:1], "dense, kernels")
    del prog
    torch.cuda.empty_cache()
    if dense_run["digest"][0] != run["digest"][0] \
            or dense_run["losses"][0] != run["losses"][0]:
        raise AssertionError("compressed dense's step-0 residuals or loss "
                             "differ from compressed zen's")
    res = {"launches": launches, "losses": run["losses"],
           "words": run["words"], "dense_words_uncompressed": dense_words,
           "word_share": share, "step_s": run["step_s"],
           "median_step_s": float(np.median(run["step_s"][1:])),
           "tok_per_s": run["tok_per_s"], "peak_gib": peak,
           "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"],
           "wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
           "zen_ms": zen_ms, "plain_step_s": plain_run["step_s"],
           "dense_step_s": dense_run["step_s"], **checks}
    log(f"[compress] 8x1 {COMPRESS} 25 MiB buckets: cuda == torch route "
        f"bitwise ({plain_steps} steps: losses, words, residual digests); "
        f"dense step-0 residual digest == zen's; words {share:.4f} of "
        f"dense; median step s after the first {res['median_step_s']}, "
        f"tok/s {run['tok_per_s']}, peak {peak:.2f} GiB | {smi}")
    log(f"[compress] json {json.dumps(res)}")
    return res


def overlap_case(dev, **route):
    """A GradSync on ``SimGroup(8)`` with 25 MiB buckets over the qwen2
    slice's ``embed/table`` [M, d] bf16 between two runs of three
    [d, 4864] bf16 leaves (one fused bucket each) and an f32 [d] leaf, and
    its seeded gradients: Zipf rows for the table, normal values for the
    rest.  The pipeline then encodes the table beside the first dense
    bucket's psum, and gathers the second beside the table's commit."""
    from repro_torch.core.zen import GradSync, SyncConfig

    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    bf = torch.bfloat16
    leaves = ([(f"pre/{i}", (d, 4864), bf) for i in range(3)]
              + [("embed/table", (M, d), bf)]
              + [(f"post/{i}", (4864, d), bf) for i in range(3)]
              + [("norm", (d,), torch.float32)])
    gs = GradSync(SyncConfig(density_budget=SLICE["density_budget"],
                             bucket_bytes=BUCKET_BYTES, **route),
                  ["embed/table"], leaves, n)
    g = torch.Generator(device=dev).manual_seed(2)
    grads = {nm: torch.randn((n, *shape), generator=g, device=dev).to(dt)
             for nm, shape, dt in leaves if nm != "embed/table"}
    grads["embed/table"] = zipf_rows(np.random.default_rng(1), n, M,
                                     SLICE["tokens"], d, bf, dev)
    return gs, grads


def stream_overlap(trace_path: Path) -> dict:
    """From a torch.profiler chrome trace: the device time of the kernels
    on the stream that runs ``zen_encode`` (GradSync's side stream, every
    encode), how much of it lies inside kernels of other streams, and the
    union of all device activity (µs)."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    by_stream: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            by_stream.setdefault(e.get("args", {}).get("stream"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    side = [s for s, evs in by_stream.items()
            if any("zen_encode" in nm for _, _, nm in evs)]
    if len(side) != 1:
        raise AssertionError(f"zen_encode ran on streams {side}, expected "
                             f"one side stream")
    side_iv = [(a, b) for a, b, _ in by_stream[side[0]]]
    other = union([(a, b) for s, evs in by_stream.items() if s != side[0]
                   for a, b, _ in evs])
    hidden = sum(max(0.0, min(b, y) - max(a, x))
                 for a, b in side_iv for x, y in other)
    every = union([(a, b) for evs in by_stream.values() for a, b, _ in evs])
    return {"side_stream": side[0], "streams": sorted(map(str, by_stream)),
            "encode_us": sum(b - a for a, b in side_iv),
            "hidden_us": hidden,
            "busy_us": sum(b - a for a, b in every),
            "span_us": (every[-1][1] - every[0][0]) if every else 0.0}


def profiled_bucketed_step(smi: str) -> dict:
    """One torch.profiler step of the 8x1 smoke trainer with 25 MiB
    buckets (after a warm-up step): the share of the encodes' device time
    hidden under other streams' kernels, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.zen import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    torch.cuda.empty_cache()
    cfg = get_config("qwen2-0.5b")
    prog = build_program(cfg, "8x1", TrainerConfig(
        sync=SyncConfig(bucket_bytes=BUCKET_BYTES)), device="cuda")
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8)))
    batches = [{k: torch.as_tensor(v, device="cuda").long()
                for k, v in next(data).items()} for _ in range(2)]
    prog.train_step(batches[0])
    torch.cuda.synchronize()
    work = Path(tempfile.mkdtemp(prefix="overlap_trace_"))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prog.train_step(batches[1])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        prof.export_chrome_trace(str(work / "trace.json"))
        ov = stream_overlap(work / "trace.json")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del prog
    torch.cuda.empty_cache()
    ov["wall_us"] = wall_us
    ov["hidden_share"] = ov["hidden_us"] / ov["encode_us"]
    ov["idle_share"] = 1 - ov["busy_us"] / wall_us
    log(f"[overlap] profiled bucketed 8x1 step: wall {wall_us / 1e3:.3f} ms, "
        f"device busy (union of streams) {ov['busy_us'] / 1e3:.3f} ms, idle "
        f"share {ov['idle_share']:.4f}; encodes on stream "
        f"{ov['side_stream']} (streams {ov['streams']}): "
        f"{ov['encode_us'] / 1e3:.4f} ms of device time, "
        f"{ov['hidden_us'] / 1e3:.4f} ms of it inside other streams' "
        f"kernels (share {ov['hidden_share']:.4f}) | {smi}")
    return ov


def phase_overlap(dev, smi: str) -> dict:
    """GradSync's pipeline (encodes on its side stream) against
    ``schedule.run_in_order`` on the current stream, bitwise, repeated, on
    the fused route and the unfused chain at the qwen2 slice shapes; then
    one profiled bucketed trainer step."""
    from repro_torch.kernels import ops as K
    from repro_torch.train import schedule

    for route, kw in (("fused", {}), ("unfused", UNFUSED)):
        torch.cuda.empty_cache()
        gs, grads = overlap_case(dev, **kw)
        flat, payloads = gs._payloads(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_st = gs._unbucket(flat, *schedule.run_in_order(
            gs.plan.buckets, payloads, gs._encode_bucket, gs._commit_bucket))
        torch.cuda.synchronize()
        in_order_s = time.perf_counter() - t0
        secs = []
        for rep in range(OVERLAP_REPEATS):
            K.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, st = gs(grads)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check_launches(f"overlap {route} repeat {rep}", K.LAUNCHES,
                           K.PLAIN_CALLS,
                           K.path_launches(SLICE["n"], **kw))
            for name, a in [*got.items(), *st.items()]:
                b = want[name] if name in want else want_st[name]
                if a.dtype != b.dtype or a.shape != b.shape \
                        or not torch.equal(bits(a), bits(b)):
                    raise AssertionError(f"overlap {route} repeat {rep}: "
                                         f"{name} differs from run_in_order")
            del got, st
        log(f"[overlap] {route}: {len(gs.plan.buckets)} buckets "
            f"({', '.join(b.kind for b in gs.plan.buckets)}); GradSync on "
            f"two streams == run_in_order bitwise, {OVERLAP_REPEATS} "
            f"repeats; host s a call: in order {in_order_s:.4f} (first "
            f"call), pipelined {[round(x, 4) for x in secs]}")
        del gs, grads, flat, payloads, want, want_st
    return profiled_bucketed_step(smi)


# ---------------------------------------------------------------------------
# the baseline schemes (agsparse, sparcml, sparse_ps, omnireduce, balanced)
# ---------------------------------------------------------------------------

SCHEMES = ("agsparse", "sparcml", "sparse_ps", "omnireduce", "balanced")
SCHEME_STEPS = 2
SCHEME_LOSS_TOL = 1e-3


def scheme_sync(name: str, g: torch.Tensor, backend: str, group=None):
    """One sync of ``name`` over [local, M, d] worker gradients, provisioned
    as GradSync provisions the embedding (``stage_args_for`` at the slice's
    budget) and dispatched through ``stage_sync``."""
    from repro_torch.core import schemes as S

    group = group or S.SimGroup(g.shape[0])
    args = S.stage_args_for(name, rows=g.shape[1],
                            budget=SLICE["density_budget"], backend=backend)
    return S.stage_sync(name, g, group=group, n=group.n, stage_args=args)


def dyadic(g: torch.Tensor) -> torch.Tensor:
    """``g``'s values rounded to multiples of 1/8 in [-2, 2]: every sum of
    8 of them is exact in bf16, in any order."""
    return (g.float() * 8).round().clamp(-16, 16).div(8).to(g.dtype)


def scheme_streams(dev) -> dict:
    """The slice's embedding gradients, bf16 [8, 151936, 896]: the Zipf(1.2)
    8 x 512-token rows (random values, and rounded to dyadic values) and a
    0.2 row-density stream (dyadic)."""
    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    z = zipf_rows(np.random.default_rng(1), n, M, SLICE["tokens"], d,
                  torch.bfloat16, dev)
    return {"zipf": z, "zipf-dyadic": dyadic(z),
            "dense-dyadic": dyadic(dense_rows(np.random.default_rng(2), n, M,
                                              0.2, d, torch.bfloat16, dev))}


def rows_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two [n, ...] outputs, row by row (an expanded
    output holds one decode seen by every worker)."""
    return a.shape == b.shape and a.dtype == b.dtype and all(
        torch.equal(bits(a[w]), bits(b[w])) for w in range(a.shape[0]))


def scheme_syncs(dev, smi: str) -> dict:
    """Each scheme at the slice's width on each stream: ``backend="cuda"``
    (the scatter-add kernel, counted) bitwise ``"torch"`` (outputs, words,
    overflow); no overflow; on the dyadic streams every worker's output
    exactly the psum of the inputs, on the random one within bf16's
    rounding of it; ms per sync on both routes (CUDA events)."""
    from repro_torch.kernels import ops as K

    res = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    streams = scheme_streams(dev)
    for sname, g in streams.items():
        ref = g.float().sum(0)
        for name in SCHEMES:
            K.reset_counts()
            a_out, a_st = scheme_sync(name, g, "cuda")
            launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
            b_out, b_st = scheme_sync(name, g, "torch")
            if not (rows_equal(a_out, b_out)
                    and torch.equal(bits(a_st.sent_words),
                                    bits(b_st.sent_words))
                    and torch.equal(a_st.overflow, b_st.overflow)):
                raise AssertionError(f"[schemes] {name} {sname}: cuda and "
                                     f"torch routes differ")
            if launches["coo_scatter_add"] == 0 or any(plain.values()) \
                    or sum(launches.values()) != launches["coo_scatter_add"]:
                raise AssertionError(f"[schemes] {name} {sname}: launches "
                                     f"{launches}, plain {plain}")
            if int(a_st.overflow.sum()):
                raise AssertionError(f"[schemes] {name} {sname}: overflow "
                                     f"{a_st.overflow.tolist()}")
            worst = max(float((a_out[w].float() - ref).abs().max())
                        for w in range(g.shape[0]))
            if sname.endswith("dyadic") and worst != 0.0:
                raise AssertionError(f"[schemes] {name} {sname}: not the "
                                     f"exact psum (max |diff| {worst})")
            if not sname.endswith("dyadic") and not all(torch.allclose(
                    a_out[w].float(), ref, atol=0.1, rtol=0.02)
                    for w in range(g.shape[0])):
                raise AssertionError(f"[schemes] {name} {sname}: not the "
                                     f"psum (max |diff| {worst})")
            del a_out, b_out
            ms = cuda_time_ms(lambda: scheme_sync(name, g, "cuda"), iters=5)
            plain_ms = cuda_time_ms(lambda: scheme_sync(name, g, "torch"),
                                    iters=3)
            res[f"{name} {sname}"] = {
                "sent_words": float(a_st.sent_words[0]),
                "launches": launches["coo_scatter_add"], "ms": ms,
                "plain_ms": plain_ms, "psum_max_abs_diff": worst}
            log(f"[schemes] {name} {sname}: cuda == torch bitwise, overflow "
                f"0, psum max |diff| {worst}, sent_words[0] "
                f"{float(a_st.sent_words[0])}, coo_scatter_add launches "
                f"{launches['coo_scatter_add']}, {ms:.3f} ms a sync (torch "
                f"route {plain_ms:.3f} ms) | {smi}")
            torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[schemes] peak memory over the syncs {peak / 2**30:.2f} GiB "
        f"(three [8, 151936, 896] bf16 streams held: "
        f"{3 * streams['zipf'].numel() * 2 / 2**30:.2f} GiB) | {smi}")
    row = scatter_agsparse_times(streams["zipf"], smi)
    del streams
    torch.cuda.empty_cache()
    return {"syncs": res, "row_8b": row, "peak_bytes": peak}


def scatter_agsparse_times(g: torch.Tensor, smi: str) -> dict:
    """Row 8b: ``coo_scatter_add`` at agsparse's reduce on the Zipf stream:
    the 8 gathered workers' 37,984 EMPTY-padded rows each into [151936,
    896] bf16, against ``index_add_`` on the live rows."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import ops as K, ref as R

    cap = max(64, int(SLICE["M"] * SLICE["density_budget"]))
    idx, vals, _ = S._encode_rows(g, cap)
    idx = idx.reshape(-1).contiguous()
    vals = vals.reshape(idx.numel(), -1).contiguous()
    out = torch.zeros_like(g[0])
    keep = idx != 2**31 - 1
    lib_idx, lib_vals = idx[keep].long(), vals[keep]
    live, touched = int(keep.sum()), int(torch.unique(idx[keep]).numel())
    d, el = vals.shape[1], vals.element_size()
    log(f"[times] coo_scatter_add at agsparse's reduce: C={idx.numel()} "
        f"live rows={live} touched targets={touched}")
    return time_row(
        "coo_scatter_add (agsparse reduce)",
        lambda: K.coo_scatter_add_op(out, idx, vals),
        lambda: R.coo_scatter_add_ref(out, idx, vals),
        lambda: out.index_add_(0, lib_idx, lib_vals),
        idx.numel() * 4 + live * d * el + 2 * touched * d * el, live * d,
        OPS_PER_S, smi, plain_iters=5)


def scheme_argv(sync: str, steps: int, *extra: str) -> list[str]:
    """``qwen_argv``'s 8x1 smoke trainer with ``--sync sync``."""
    argv = qwen_argv(8, steps, *extra)
    argv[argv.index("--sync") + 1] = sync
    return argv


def scheme_trainer(sync: str, steps: int, *extra: str) -> dict:
    """``launch/train.py`` on ``scheme_argv``, the kernel counts from 0
    around the run."""
    from repro_torch.kernels import ops as K
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    K.reset_counts()
    res = train.main(scheme_argv(sync, steps, *extra))
    res["launches"], res["plain"] = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    torch.cuda.empty_cache()
    return res


def scheme_trainers(smi: str, zen: dict | None) -> dict:
    """The full-width 8x1 trainer under ``--sync auto`` (4 steps: the plan
    puts zen on ``embed/table``; the losses bitwise ``--sync zen``'s) and
    under each scheme (2 steps on the kernels, bitwise its ``--backend
    torch`` run, within 1e-3 of zen's losses, ``coo_scatter_add`` launched
    and nothing plain)."""
    if zen is None:
        zen = scheme_trainer("zen", 4)
    out = {"zen": zen}
    auto = scheme_trainer("auto", 4)
    emb = [ln for ln in auto["plan"] if ln.endswith("embed/table")]
    log(f"[schemes] auto plan: {emb} losses={auto['losses']} tok/s="
        f"{auto['tok_per_s']} step_s={auto['step_s']} | {smi}")
    if len(emb) != 1 or "plan=[zen@data[8]]" not in emb[0]:
        raise AssertionError(f"[schemes] auto did not put zen on "
                             f"embed/table: {emb}")
    if auto["losses"] != zen["losses"] \
            or auto["sparse_words_by_step"] != zen["sparse_words_by_step"]:
        raise AssertionError(f"[schemes] auto {auto['losses']} != zen "
                             f"{zen['losses']}")
    out["auto"] = auto
    for name in SCHEMES:
        run = scheme_trainer(name, SCHEME_STEPS)
        plain = scheme_trainer(name, SCHEME_STEPS, "--backend", "torch")
        for k in ("losses", "sparse_words_by_step", "grad_norm"):
            if run[k] != plain[k]:
                raise AssertionError(f"[schemes] {name} trainer {k}: kernels "
                                     f"{run[k]} != plain route {plain[k]}")
        diff = max(abs(a - b) for a, b in zip(run["losses"], zen["losses"]))
        if not all(np.isfinite(run["losses"])) or diff > SCHEME_LOSS_TOL:
            raise AssertionError(f"[schemes] {name} trainer losses "
                                 f"{run['losses']} vs zen {zen['losses']}")
        if run["overflow"] or run["launches"]["coo_scatter_add"] == 0 \
                or any(run["plain"].values()) \
                or any(run["launches"][k] for k in ("zen_encode",
                                                    "zen_commit_push",
                                                    "zen_commit_pull")):
            raise AssertionError(f"[schemes] {name} trainer: overflow "
                                 f"{run['overflow']} launches "
                                 f"{run['launches']} plain {run['plain']}")
        run["bitwise_zen"] = run["losses"] == zen["losses"][:SCHEME_STEPS]
        run["max_diff_zen"] = diff
        log(f"[schemes] {name} trainer: losses={run['losses']} (bitwise the "
            f"plain route; zen's {'bitwise' if run['bitwise_zen'] else diff})"
            f" words={run['sparse_words_by_step']} overflow={run['overflow']}"
            f" step_s={run['step_s']} tok/s={run['tok_per_s']} "
            f"coo_scatter_add launches={run['launches']['coo_scatter_add']} "
            f"(plain route step_s={plain['step_s']}) | {smi}")
        out[name] = run
    return out


def phase_schemes(smi: str, zen: dict | None = None) -> dict:
    """The baseline schemes at the slice's full width, then their trainers
    and ``--sync auto``'s (``zen``: the trainer phase's fused run, when it
    ran)."""
    dev = torch.device("cuda")
    syncs = scheme_syncs(dev, smi)
    trainers = scheme_trainers(smi, zen)
    return {**syncs, "trainers": trainers}


# ---------------------------------------------------------------------------
# two-level topologies: the 8x1 trainer on nodes of 4 and of 2 ranks
# ---------------------------------------------------------------------------

# (node size, --sync, extra flags) of the hier phase's trainers
HIER_RUNS = ((4, "zen"), (4, "auto"), (2, "zen"), (2, "auto"),
             (2, "zen", "--bucket-bytes", str(BUCKET_BYTES)))
# 'auto''s plan for embed/table at 8 ranks (the reference's cost model)
HIER_AUTO = {4: "hier(sparcml@intra,dense@inter)",
             2: "hier(agsparse@intra,zen@inter)"}
HIER_STEPS, HIER_PLAIN_STEPS = 4, 2
# two levels add each psum's terms in another order (node sums first), in
# bf16: the step-0 loss is the flat run's bits, later ones move as the dist
# trainer's do when gloo reorders its 4-rank psum (DIST_LOSS_TOL)
HIER_LOSS_TOL = 5e-3
ZEN_KERNELS = ("zen_encode", "zen_commit_push", "zen_commit_pull")


def hier_trainer(ns: int, sync: str, steps: int, *extra: str) -> dict:
    """``scheme_trainer`` with ``--node-size ns``, the peak of the card's
    allocated memory over the run beside it."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = scheme_trainer(sync, steps, "--node-size", str(ns), *extra)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def hier_launches(ns: int, sync: str, steps: int) -> dict:
    """The Zen kernels' launches a run should make: under ``zen`` a
    worker's encode, a server's push and a worker's pull at each of the
    two levels (the inter level once for each of the ns columns of 8 / ns
    ranks: Zen's intra outputs are a stack of per-worker decodes); under
    ``auto`` Zen runs at the inter level only at node size 2, once over
    the 4 node sums (agsparse hands a node's workers one shared sum, so
    the columns' inputs are the same tensors, ``schemes.level_sync``),
    and not at all at 4."""
    n = SLICE["n"]
    per = {"zen": 2 * n, "auto": n // ns if ns == 2 else 0}[sync]
    return {k: steps * per for k in ZEN_KERNELS}


def phase_hier(smi: str, flat: dict | None = None) -> dict:
    """The full-size qwen2-0.5b 8x1 trainer on two-level topologies
    (``HIER_RUNS``): the kernel route (4 steps) bitwise its ``--backend
    torch`` route over the plain route's 2 steps (losses, grad norm, words
    at each level, overflow 0), the step-0 loss bitwise the flat Zen run's
    and later ones within ``HIER_LOSS_TOL`` (``flat``: the trainer phase's
    run), the Zen kernels at both levels
    under ``zen`` and ``coo_scatter_add`` under ``auto``, nothing plain;
    the plans, words, step times and peak memory logged."""
    if flat is None:
        flat = scheme_trainer("zen", HIER_STEPS)
    out = {}
    for ns, sync, *extra in HIER_RUNS:
        tag = f"node_size {ns} --sync {sync}{' ' if extra else ''}" \
            + " ".join(extra)
        run = hier_trainer(ns, sync, HIER_STEPS, *extra)
        plain = hier_trainer(ns, sync, HIER_PLAIN_STEPS, *extra,
                             "--backend", "torch")
        plan = [ln for ln in run["plan"]
                if ln.startswith("topology") or ln.endswith("embed/table")]
        for ln in plan:
            log(f"[hier] {tag}: {ln}")
        log(f"[hier] {tag}: (the topology's α-β are the cost model's "
            f"planning constants, not measurements)")
        k = HIER_PLAIN_STEPS
        for key in ("losses", "grad_norm", "sparse_words_by_step",
                    "dense_words", "intra_words", "inter_words"):
            if run[key][:k] != plain[key]:
                raise AssertionError(f"[hier] {tag} {key}: kernels "
                                     f"{run[key][:k]} != plain route "
                                     f"{plain[key]}")
        diff = max(abs(a - b) for a, b in zip(run["losses"], flat["losses"]))
        log(f"[hier] {tag}: losses={run['losses']} (plain route bitwise over "
            f"{k} steps; flat zen {flat['losses']}, max |diff| {diff}) "
            f"intra_words={run['intra_words']} inter_words="
            f"{run['inter_words']} sparse_words={run['sparse_words_by_step']}"
            f" dense_words={run['dense_words']} overflow={run['overflow']} "
            f"step_s={run['step_s']} (median after the first "
            f"{np.median(run['step_s'][1:])}; plain route {plain['step_s']})"
            f" tok/s={run['tok_per_s']} peak {run['peak_gib']:.2f} GiB; "
            f"launches {run['launches']} | {smi}")
        gdiff = abs(run["grad_norm"][0] - flat["grad_norm"][0])
        log(f"[hier] {tag}: |loss - flat's| by step "
            f"{[abs(a - b) for a, b in zip(run['losses'], flat['losses'])]}; "
            f"step-0 grad norm {run['grad_norm'][0]} vs flat "
            f"{flat['grad_norm'][0]} (relative {gdiff / flat['grad_norm'][0]})")
        if not all(np.isfinite(run["losses"])) or diff > HIER_LOSS_TOL \
                or run["losses"][0] != flat["losses"][0]:
            raise AssertionError(f"[hier] {tag} losses {run['losses']} vs "
                                 f"flat {flat['losses']}")
        if run["overflow"] or plain["overflow"] or any(run["plain"].values()):
            raise AssertionError(f"[hier] {tag}: overflow {run['overflow']}/"
                                 f"{plain['overflow']} plain {run['plain']}")
        want = hier_launches(ns, sync, HIER_STEPS)
        got = {k: run["launches"][k] for k in ZEN_KERNELS}
        if got != want:
            raise AssertionError(f"[hier] {tag}: Zen launches {got}, "
                                 f"expected {want}")
        if sync == "auto":
            emb = [ln for ln in run["plan"] if ln.endswith("embed/table")]
            stages = HIER_AUTO[ns][5:-1].split(",")
            want_plan = " ; ".join(
                f"{st.split('@')[0]}@dp_{st.split('@')[1]}[{sz}]"
                for st, sz in zip(stages, (ns, SLICE["n"] // ns)))
            if len(emb) != 1 or f"plan=[{want_plan}]" not in emb[0] \
                    or run["launches"]["coo_scatter_add"] == 0:
                raise AssertionError(f"[hier] {tag}: plan {emb} (expected "
                                     f"{HIER_AUTO[ns]}), coo_scatter_add "
                                     f"{run['launches']['coo_scatter_add']}")
        elif run["launches"]["coo_scatter_add"]:
            raise AssertionError(f"[hier] {tag}: coo_scatter_add launched")
        out[tag] = run
    return out


# ---------------------------------------------------------------------------
# data parallelism over a torch.distributed group: one process per rank
# ---------------------------------------------------------------------------

ROUTES = ((True, True), (False, True), (True, False), (False, False))
DIST_ZEN_RANKS = 8         # zen_sync at the slice's n, every rank on cuda:0
DIST_TRAIN_RANKS = 4       # about 12 GB a full-width trainer rank
DIST_TIMEOUT_S = 600
# the gloo trainer's losses against the in-process run's: gloo adds a
# 4-rank psum in its own order (bf16), which moves later steps' losses
DIST_LOSS_TOL = 5e-3


def sync_digest(out: torch.Tensor, sent: torch.Tensor,
                ovf: torch.Tensor) -> str:
    """sha256 of one worker's synced [M, d] rows (the indices of the rows
    whose bits are not all zero, then their bits) and its stats' bits."""
    b = bits(out)
    live = (b != 0).any(dim=-1).nonzero().squeeze(1).to(torch.int32)
    h = hashlib.sha256()
    for t in (live, b[live], bits(sent.float()), ovf.to(torch.int32)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run_ranks(n: int, args: list[str], tag: str) -> str:
    """``torchrun --standalone --nproc-per-node n`` on ``args`` with
    ``src`` on the path, in its own session so that a timeout stops every
    rank; returns its stdout, raises on a non-zero exit."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), *args]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"[{tag}] {n} ranks did not finish in "
                             f"{DIST_TIMEOUT_S} s")
    log(f"[{tag}] {n} ranks exited {proc.returncode} in "
        f"{time.time() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] torchrun exited {proc.returncode}:\n"
                             f"{out[-4000:]}\n{err[-8000:]}")
    return out


def dist_zen_sync_rank(group, dev, work: Path) -> None:
    """One rank of the gloo zen_sync check: its worker's gradient from
    ``work/in<w>.pt``, zen_sync on every route on the card, the digests,
    launches and host seconds to ``work/out<w>.json``."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import ops as K

    w = group.ranks[0]
    inp = torch.load(work / f"in{w}.pt")
    M, d = SLICE["M"], SLICE["d"]
    lo = S.make_zen_layout(M, group.n,
                           density_budget=SLICE["density_budget"])
    g = torch.zeros((1, M, d), dtype=torch.bfloat16, device=dev)
    g[0, inp["ids"].to(dev)] = inp["vals"].to(dev)
    res = {}
    for fe, fc in ROUTES:
        K.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out, st = S.zen_sync(g, group=group, layout=lo, backend="cuda",
                             fused=fe, fused_commit=fc)
        torch.cuda.synchronize()
        res[f"{fe},{fc}"] = {
            "s": time.time() - t0, "shape": list(out.shape),
            "digest": sync_digest(out[0], st.sent_words[0],
                                  st.overflow[0]),
            "launches": dict(K.LAUNCHES), "plain": dict(K.PLAIN_CALLS)}
        del out
    for name in SCHEMES:   # the baselines, their aggregation on the kernel
        K.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out, st = scheme_sync(name, g, "cuda", group)
        torch.cuda.synchronize()
        res[name] = {
            "s": time.time() - t0, "shape": list(out.shape),
            "digest": sync_digest(out[0], st.sent_words[0], st.overflow[0]),
            "launches": dict(K.LAUNCHES), "plain": dict(K.PLAIN_CALLS)}
        del out
    for ns, tag in DIST_HIER:   # two-level plans over the level groups
        K.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out, st = hier_case(g, ns, tag, group)
        torch.cuda.synchronize()
        res[f"{ns} {tag}"] = {
            "s": time.time() - t0, "shape": list(out.shape),
            "digest": hier_digest(out, st, 0),
            "launches": dict(K.LAUNCHES), "plain": dict(K.PLAIN_CALLS)}
        del out
    (work / f"out{w}.json").write_text(json.dumps(res))


# (node size, plan tag) of the dist phase's two-level zen_sync check: Zen at
# both levels, and 'auto''s plans for embed/table at 8 ranks
DIST_HIER = ((4, "hier(zen@intra,zen@inter)"),
             (4, "hier(sparcml@intra,dense@inter)"),
             (2, "hier(zen@intra,zen@inter)"),
             (2, "hier(agsparse@intra,zen@inter)"))


def hier_case(g: torch.Tensor, ns: int, tag: str, group=None):
    """``hier_sync`` of the plan ``tag`` over nodes of ``ns`` of the 8
    ranks, stages provisioned by ``plan_stage_args`` at the slice's
    budget, on the kernels: on ``group`` (this rank's [1, M, d]) or, with
    None, ``simulate_hier`` of the [8, M, d] stack in this process."""
    from repro_torch.core import schemes as S
    from repro_torch.core.topology import build_topology, parse_plan
    from repro_torch.launch.mesh import make_level_groups

    topo, plan = build_topology(DIST_ZEN_RANKS, ns), parse_plan(tag)
    kw = S.plan_stage_args(plan, topo, SLICE["M"],
                           density_budget=SLICE["density_budget"],
                           backend="cuda")
    if group is None:
        return S.simulate_hier(g, topology=topo, plan=plan, stage_kw=kw)
    make_level_groups(group, topo)
    return S.hier_sync(g, group=group, topology=topo, plan=plan, stage_kw=kw)


def hier_digest(out: torch.Tensor, st, w: int) -> str:
    """``sync_digest`` of worker ``w`` with each level's words."""
    sent = torch.stack([st.sent_words[w], *(b[w] for b in st.by_level)])
    return sync_digest(out[w], sent, st.overflow[w])


def step_parts(prog, batch: dict, barrier=None, reps: int = 3) -> dict:
    """Median host seconds (a device sync at both ends; ``barrier`` first,
    so a process group starts each part together) of the trainer's step
    and its parts after one warm step: every local rank's forward and
    backward, zen_sync of ``embed/table`` and the whole GradSync (Zen
    plus the dense psums) on zero gradients of the step's shapes, whose
    wire buffers are the capacity-sized ones of any step."""
    from repro_torch.core import schemes as S
    from repro_torch.train.steps import split_batch

    model, ranks = prog.model, tuple(prog.group.ranks)
    per_rank = split_batch(batch, prog.n_data)
    stacks = {nm: torch.zeros((len(ranks), *p.shape), dtype=p.dtype,
                              device=p.device)
              for nm, p in model.named_leaves()}
    lo = prog.gradsync._layouts["embed/table", 0]

    def fwd_bwd():
        for r in ranks:
            model.zero_grad(set_to_none=True)
            model(per_rank[r]["tokens"], per_rank[r]["labels"]).backward()

    parts = {"step": lambda: prog.train_step(batch),
             "forward+backward": fwd_bwd,
             "zen_sync embed/table": lambda: S.zen_sync(
                 stacks["embed/table"], group=prog.group, layout=lo,
                 backend="cuda"),
             "GradSync": lambda: prog.gradsync(stacks)}
    prog.train_step(batch)
    out = {}
    for name, fn in parts.items():
        ts = []
        for _ in range(reps):
            if barrier is not None:
                barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = float(np.median(ts))
    model.zero_grad(set_to_none=True)
    return out


def smoke_trainer(n: int, group=None, dev="cuda", bucket_bytes=None):
    """The dist phase's trainer (``launch/train.py``'s flags: qwen2-0.5b,
    Zen, global batch 8 x 512 tokens, seed 0; dense buckets of
    ``bucket_bytes``) on ``n`` ranks and its first batch."""
    from repro_torch.configs import get_config
    from repro_torch.core.zen import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    cfg = get_config("qwen2-0.5b")
    prog = build_program(cfg, f"{n}x1", TrainerConfig(
        sync=SyncConfig(bucket_bytes=bucket_bytes)), device=dev, group=group)
    attach_train(prog)
    b = next(iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8))))
    return prog, {k: torch.as_tensor(v, device=dev).long()
                  for k, v in b.items()}


PART_VARIANTS = {"per-leaf": None, "25 MiB buckets": BUCKET_BYTES}


def trainer_parts(n: int, group=None, dev="cuda", barrier=None) -> dict:
    """``step_parts`` of the n-rank smoke trainer, per leaf and with 25 MiB
    buckets, one program at a time."""
    parts = {}
    for tag, bb in PART_VARIANTS.items():
        prog, batch = smoke_trainer(n, group, dev, bb)
        parts[tag] = step_parts(prog, batch, barrier=barrier)
        del prog
        torch.cuda.empty_cache()
    return parts


def dist_breakdown_rank(group, dev, work: Path) -> None:
    """One rank of the gloo trainer's step breakdown; rank 0 writes it to
    ``work/parts.json``."""
    import torch.distributed as dist

    parts = trainer_parts(group.n, group, dev, barrier=dist.barrier)
    if group.ranks[0] == 0:
        (work / "parts.json").write_text(json.dumps(parts))


def dist_rank(job: str, work: Path) -> None:
    """One rank of a dist-phase job, run under torchrun."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_group

    group, dev = make_data_group("gloo")
    try:
        {"zen_sync": dist_zen_sync_rank,
         "breakdown": dist_breakdown_rank}[job](group, dev, work)
    finally:
        dist.destroy_process_group()


def dist_zen_sync(dev) -> None:
    """zen_sync at the slice shapes over an 8-rank gloo group, every rank
    on this card, against the in-process simulate on the card: each rank's
    output and stats bitwise row w of it (sha256 digests), on all four
    routes, with each route's kernels launched once per rank; then the
    five baseline schemes on the same ranks (sparcml's exchange an
    alltoallv), bitwise their in-process rows, ``coo_scatter_add``
    launched on every rank and nothing plain."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import ops as K

    M, d, n = SLICE["M"], SLICE["d"], DIST_ZEN_RANKS
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    g = zipf_rows(np.random.default_rng(1), n, M, SLICE["tokens"], d,
                  torch.bfloat16, dev)
    want = {}
    for fe, fc in ROUTES:
        out, st = S.simulate(S.zen_sync, g, layout=lo, backend="cuda",
                             fused=fe, fused_commit=fc)
        want[f"{fe},{fc}"] = [sync_digest(out[w], st.sent_words[w],
                                          st.overflow[w]) for w in range(n)]
        del out
    for name in SCHEMES:
        out, st = scheme_sync(name, g, "cuda")
        want[name] = [sync_digest(out[w], st.sent_words[w], st.overflow[w])
                      for w in range(n)]
        del out
    want_hier = {}
    for ns, tag in DIST_HIER:
        out, st = hier_case(g, ns, tag)
        want_hier[f"{ns} {tag}"] = [hier_digest(out, st, w)
                                    for w in range(n)]
        log(f"[dist] {tag} over nodes of {ns}: in-process words by level "
            f"{[float(b[0]) for b in st.by_level]}, overflow "
            f"{int(st.overflow.sum())}")
        del out
    work = Path(tempfile.mkdtemp(prefix="dist_zen_sync_"))
    try:
        for w in range(n):
            ids = (bits(g[w]) != 0).any(dim=-1).nonzero().squeeze(1)
            torch.save({"ids": ids.cpu(), "vals": g[w, ids].cpu()},
                       work / f"in{w}.pt")
        del g
        torch.cuda.empty_cache()
        run_ranks(n, [str(Path(__file__).resolve()), "--dist-rank",
                      "zen_sync", str(work)], "dist zen_sync")
        got = [json.loads((work / f"out{w}.json").read_text())
               for w in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in SCHEMES:
        for w in range(n):
            r = got[w][name]
            if r["digest"] != want[name][w] or r["shape"] != [1, M, d]:
                raise AssertionError(f"dist {name} rank {w}: output or stats "
                                     f"differ from the in-process row {w}")
            if r["launches"]["coo_scatter_add"] == 0 \
                    or any(r["plain"].values()) or sum(
                        r["launches"].values()) != r["launches"][
                            "coo_scatter_add"]:
                raise AssertionError(f"dist {name} rank {w}: launches "
                                     f"{r['launches']} plain {r['plain']}")
        log(f"[dist] {name}: {n} gloo ranks bitwise the in-process rows, "
            f"coo_scatter_add launches per rank "
            f"{[got[w][name]['launches']['coo_scatter_add'] for w in range(n)]}"
            f"; host s per rank {[got[w][name]['s'] for w in range(n)]}")
    for key, digests in want_hier.items():
        ns, tag = key.split(" ", 1)
        for w in range(n):
            r = got[w][key]
            if r["digest"] != digests[w] or r["shape"] != [1, M, d]:
                raise AssertionError(f"dist {tag} over nodes of {ns} rank "
                                     f"{w}: output or stats differ from the "
                                     f"in-process row {w}")
            zen = [r["launches"][k] for k in ZEN_KERNELS]
            want_zen = [tag.count("zen@")] * 3
            if zen != want_zen or any(r["plain"].values()) or (
                    ("agsparse" in tag or "sparcml" in tag)
                    != (r["launches"]["coo_scatter_add"] > 0)):
                raise AssertionError(f"dist {tag} over nodes of {ns} rank "
                                     f"{w}: launches {r['launches']} plain "
                                     f"{r['plain']}")
        log(f"[dist] {tag} over nodes of {ns}: {n} gloo ranks (level groups "
            f"by dist.new_group) bitwise the in-process rows, words by level "
            f"included; launches per rank {got[0][key]['launches']}; host s "
            f"per rank {[got[w][key]['s'] for w in range(n)]}")
    for route in [r for r in want if r not in SCHEMES]:
        digests = want[route]
        fe, fc = (r == "True" for r in route.split(","))
        path = K.path_launches(1, fe, fc)
        for w in range(n):
            r = got[w][route]
            if r["digest"] != digests[w]:
                raise AssertionError(f"dist zen_sync (fused, fused_commit) = "
                                     f"({route}) rank {w}: output or stats "
                                     f"differ from the in-process row {w}")
            if r["shape"] != [1, M, d]:
                raise AssertionError(f"dist zen_sync rank {w} shape "
                                     f"{r['shape']}")
            for k in K.KERNELS:
                if r["launches"][k] != path.get(k, 0) or r["plain"][k]:
                    raise AssertionError(
                        f"dist zen_sync ({route}) rank {w}: {k} launched "
                        f"{r['launches'][k]} (expected {path.get(k, 0)}), "
                        f"plain {r['plain'][k]}")
        secs = [got[w][route]["s"] for w in range(n)]
        log(f"[dist] zen_sync (fused, fused_commit) = ({route}): {n} gloo "
            f"ranks bitwise the in-process rows, launches {path} per rank; "
            f"host s per rank {secs}")


def phase_dist(dev, smi: str) -> None:
    """The per-rank data-parallel path over a gloo group on this one card:
    zen_sync at the slice shapes on 8 ranks (and two-level plans over
    nodes of 4 and 2), then the full-width trainer on 4 ranks, per leaf,
    with 25 MiB buckets and on nodes of 2 ranks, against the in-process
    4x1 trainer on the same topology."""
    torch.cuda.empty_cache()
    log(f"[dist] this process holds {torch.cuda.memory_reserved(dev)} B of "
        f"the card ({torch.cuda.memory_allocated(dev)} B allocated)")
    dist_zen_sync(dev)
    dist_trainer("gloo", smi, variants=DIST_VARIANTS)


# the dist trainer's variants: (tag, extra launcher flags)
DIST_VARIANTS = (("per-leaf", ()),
                 (f"{BUCKET_BYTES} B buckets",
                  ("--bucket-bytes", str(BUCKET_BYTES))),
                 ("node_size 2", ("--node-size", "2")))


def dist_trainer(backend: str, smi: str, steps: int = 4,
                 variants=DIST_VARIANTS[:1]) -> None:
    """``torchrun ... launch.train --mesh 4x1 --dist <backend>`` at full
    width, once for each of ``variants`` (a bucket a leaf, 25 MiB buckets,
    nodes of 2 ranks), against the in-process 4x1 trainer on the same
    topology (on this process's card).  ``nccl`` needs a card a rank
    (``--only dist_nccl`` on four cards); gloo runs every rank on one
    card."""
    from repro_torch.kernels import ops as K
    from repro_torch.launch import train

    n = DIST_TRAIN_RANKS
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise AssertionError(f"dist_nccl needs {n} cards, a rank a card; "
                             f"{torch.cuda.device_count()} here")
    runs, extras = {}, {}
    for name, extra in variants:
        tag = f"{backend} {name}"
        extras[tag] = list(extra)
        torch.cuda.empty_cache()
        out = run_ranks(n, ["-m", "repro_torch.launch.train",
                            *qwen_argv(n, steps, *extra), "--dist", backend],
                        f"dist trainer {tag}")
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("dist result ")]
        if len(lines) != 1:
            raise AssertionError(f"dist trainer printed {len(lines)} result "
                                 f"lines:\n{out[-4000:]}")
        runs[tag] = json.loads(lines[0][len("dist result "):])
    locals_ = {}
    for node in sorted({"--node-size" in e for e in extras.values()}):
        K.reset_counts()
        local = train.main(qwen_argv(n, steps, *(
            ("--node-size", "2") if node else ())))
        torch.cuda.empty_cache()
        if local["overflow"] != 0:
            raise AssertionError(f"in-process trainer overflow "
                                 f"{local['overflow']}")
        levels = 2 if node else 1
        check_launches(f"in-process {n}x1 trainer", local["launches"],
                       local["plain_calls"],
                       {k: levels * steps * v
                        for k, v in K.path_launches(n).items()})
        log(f"[dist] trainer {n}x1 in-process{' node_size 2' * node}: "
            f"losses={local['losses']} sparse_words={local['sparse_words']}"
            f" intra_words={local.get('intra_words')} inter_words="
            f"{local.get('inter_words')} step_s={local['step_s']} "
            f"tok/s={local['tok_per_s']}")
        locals_[node] = local
    med = {}
    for tag, dres in runs.items():
        node = "--node-size" in extras[tag]
        local = locals_[node]
        path = {k: (2 if node else 1) * v
                for k, v in K.path_launches(1).items()}
        losses = dres["losses"]
        diff = max(abs(a - b) for a, b in zip(losses, local["losses"]))
        med[tag] = float(np.median(dres["step_s"][1:]))
        log(f"[dist] trainer {n}x1 {tag}: {len(dres['buckets'])} buckets; "
            f"losses={losses} max |diff| vs in-process={diff} sparse_words="
            f"{dres['sparse_words']} overflow={dres['overflow']} launches by "
            f"rank={dres['launches_by_rank']} plain={dres['plain_calls']} "
            f"step_s={dres['step_s']} tok/s={dres['tok_per_s']} | {smi}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"dist trainer {tag} loss not finite and "
                                 f"falling: {losses}")
        if diff > DIST_LOSS_TOL:
            raise AssertionError(f"dist trainer {tag} and the in-process "
                                 f"trainer diverge: {diff}")
        if dres["sparse_words"] != local["sparse_words"] or any(
                dres.get(k) != local.get(k)
                for k in ("intra_words", "inter_words")):
            raise AssertionError(f"dist {tag} words {dres['sparse_words']} "
                                 f"{dres.get('intra_words')} "
                                 f"{dres.get('inter_words')} != in-process "
                                 f"{local['sparse_words']} "
                                 f"{local.get('intra_words')} "
                                 f"{local.get('inter_words')}")
        if node:
            log(f"[dist] trainer {n}x1 {tag}: losses "
                f"{'bitwise' if losses == local['losses'] else 'not bitwise'}"
                f" the in-process run's (each level's psum adds 2 ranks; the "
                f"reported loss is a mean over all 4, in gloo's order), "
                f"intra_words={dres['intra_words']} inter_words="
                f"{dres['inter_words']} the same")
        if dres["overflow"] != 0:
            raise AssertionError(f"dist trainer {tag} overflow "
                                 f"{dres['overflow']}")
        for k in K.KERNELS:
            if dres["launches_by_rank"][k] != [steps * path.get(k, 0)] * n \
                    or dres["plain_calls"][k]:
                raise AssertionError(
                    f"dist trainer {tag}: {k} launched "
                    f"{dres['launches_by_rank'][k]} by rank (expected "
                    f"{steps * path.get(k, 0)} each), plain "
                    f"{dres['plain_calls'][k]}")
    for node, local in locals_.items():
        med[f"in-process{' node_size 2' * node}"] = float(
            np.median(local["step_s"][1:]))
    log(f"[dist] median step s after the first, {n} ranks: {med}; tok/s "
        f"{ {t: r['tok_per_s'] for t, r in runs.items()} }, in-process "
        f"{ {n_: r['tok_per_s'] for n_, r in locals_.items()} } | {smi}")


def dist_step_parts(n: int, smi: str) -> None:
    """Where the step's host time goes, per leaf and with 25 MiB buckets:
    ``step_parts`` on rank 0 of the gloo trainer (n processes) and on the
    in-process n-rank trainer (``--only dist_parts``; no check rides on
    it)."""
    work = Path(tempfile.mkdtemp(prefix="dist_parts_"))
    try:
        run_ranks(n, [str(Path(__file__).resolve()), "--dist-rank",
                      "breakdown", str(work)], "dist breakdown")
        parts = {"gloo": json.loads((work / "parts.json").read_text())}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parts["in-process"] = trainer_parts(n)
    for mode, by_plan in parts.items():
        for plan, pt in by_plan.items():
            log(f"[dist] {n}x1 {mode} {plan} step parts, median host s of 3: "
                f"{pt} | {smi}")


# ---------------------------------------------------------------------------
# the serving slice: prefill kernels and the server
# ---------------------------------------------------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def flash_inputs(dtype, B, S, H, KV, hd, Sk=None):
    g = torch.Generator(device="cuda").manual_seed(0)
    Sk = S if Sk is None else Sk
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def ssd_inputs(B, S, H, hd, N):
    """xh, dt (softplus), a_log, B, C, D at the scales of the model."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return (r(B, S, H, hd) * 0.5, torch.nn.functional.softplus(r(B, S, H)),
            r(H) * 0.3, r(B, S, N) * 0.4, r(B, S, N) * 0.4, r(H))


def ssd_scan_inputs(xh, dt, a_log, Bm, Cm):
    """The scan's own inputs: dt folded into x, dA = dt * A."""
    return ((xh * dt[..., None]).contiguous(),
            (dt * -torch.exp(a_log)).contiguous(), Bm, Cm)


def phase_serve_kernels() -> dict:
    """flash_fwd and ssd_fwd against their plain versions, with stated
    tolerances, at the serve shapes and their edges."""
    from repro_torch.kernels import ops as K, ref as R
    from repro_torch.models.ssm import _ssd_chunked

    err = {"flash_fwd": 0.0, "ssd_fwd": 0.0}
    f = FLASH
    cases = [("serve", dict(S=f["S"], KV=f["KV"]), {}),
             ("S=500", dict(S=500, KV=f["KV"]), {}),
             ("KV=H", dict(S=f["S"], KV=f["H"]), {}),
             ("window=64", dict(S=f["S"], KV=f["KV"]), dict(window=64)),
             ("causal=False", dict(S=f["S"], KV=f["KV"]), dict(causal=False)),
             ("q_offset", dict(S=37, KV=f["KV"], Sk=600), dict(q_offset=563)),
             ("KV=1", dict(S=f["S"], KV=1), {}),
             ("hd=32 window=64", dict(S=f["S"], KV=f["KV"], hd=32),
              dict(window=64))]
    # the wide head dims: the qwen2.5-3b and pixtral-12b prefills, ragged
    # S at both widths, a window at hd 128
    for arch, shp in FLASH_WIDE.items():
        cases += [(f"{arch} hd={shp['hd']}", shp, {}),
                  (f"S=500 hd={shp['hd']}", {**shp, "S": 500}, {})]
    cases.append(("window=64 hd=128", FLASH_WIDE["qwen2.5-3b"],
                  dict(window=64)))
    for dtype in (torch.bfloat16, torch.float32):
        for name, shp, kw in cases:
            q, k, v = flash_inputs(dtype, **{"B": f["B"], "H": f["H"],
                                             "hd": f["hd"], **shp})
            got = K.flash_fwd_op(q, k, v, **kw)
            want = R.flash_fwd_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            tol = (bf16_ulp(want) + 1e-6 if dtype == torch.bfloat16
                   else FLASH_F32_TOL)
            worst = float(diff.max())
            if got.shape != want.shape or got.dtype != want.dtype \
                    or not bool((diff <= tol).all()):
                raise AssertionError(f"flash_fwd {name} {dtype}: differs from "
                                     f"the plain version (max abs {worst})")
            err["flash_fwd"] = max(err["flash_fwd"], worst)
            log(f"[serve_kernels] flash_fwd {name} {dtype}: max abs "
                f"{worst} within "
                f"{'one bf16 ulp' if dtype == torch.bfloat16 else tol}")
    c = SSD

    def ssd_check(name, got, want):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=SSD_TOL, rtol=SSD_TOL,
                                       msg=lambda m: f"ssd_fwd {name}: {m}")
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
        err["ssd_fwd"] = max(err["ssd_fwd"], worst)
        log(f"[serve_kernels] ssd_fwd {name}: max abs {worst} within "
            f"{SSD_TOL} (atol and rtol)")

    raw = ssd_inputs(c["B"], c["S"], c["H"], c["hd"], c["N"])
    scan = ssd_scan_inputs(*raw[:5])
    for Q in (c["Q"], 16):
        ssd_check(f"serve Q={Q}", K.ssd_fwd_op(*scan, chunk=Q),
                  R.ssd_fwd_ref(*scan, chunk=Q))
    short = [t[:, :500] if t.ndim > 1 else t for t in raw]
    ssd_check("S=500 via _ssd_chunked (D != 0)",
              _ssd_chunked(*short, c["Q"], backend="cuda"),
              _ssd_chunked(*short, c["Q"], backend="torch"))
    return {"err": err, "flash": flash_inputs(torch.bfloat16, f["B"], f["S"],
                                              f["H"], f["KV"], f["hd"]),
            "ssd": scan}


def serve_run(arch: str, *extra: str) -> dict:
    from repro_torch.kernels import ops as K
    from repro_torch.launch import serve

    K.reset_counts()
    res = serve.main(["--arch", arch, "--batch", str(SERVE["batch"]),
                      "--prompt-len", str(SERVE["prompt"]),
                      "--gen", str(SERVE["gen"]), *extra])
    free_card()   # the served model before the next one is built
    return res


def free_card() -> None:
    """Return the memory of dropped models to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_cfg(arch: str, layers: int | None = None, **kw):
    """The arch's config, cut to its first ``layers`` layers if given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, **kw)


def serve_breakdown(arch: str, layers: int | None = None) -> dict:
    """One profiled bf16 prefill (after a warm one) of the serve batch."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_serve, build_program

    cfg = serve_cfg(arch, layers)
    prog = build_program(cfg, "1x1", device="cuda")
    attach_serve(prog, SERVE["prompt"], SERVE["batch"], "prefill")
    tok = torch.as_tensor(next(iter(SyntheticLM(cfg, DataConfig(
        seq_len=SERVE["prompt"], batch=SERVE["batch"]))))["tokens"],
        device="cuda").long()
    prog.prefill_step({"tokens": tok})
    out = device_breakdown(lambda: prog.prefill_step({"tokens": tok}),
                           f"serve {arch} prefill")
    del prog
    torch.cuda.empty_cache()
    return out


def reorder_control(arch: str, layers: int | None = None) -> dict | None:
    """Max |logit| difference between f32 plain-route prefills of the
    serve batch that differ only in the order of a sum: the SSD chunk (64,
    then 32) and, for the hybrid, the plain attention's KV chunk (512,
    then 64: its online softmax over 8 chunks).  How far summation order
    alone moves the logits through the model's depth.  None for models
    without Mamba2 layers."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import layers as LY
    from repro_torch.train.build import build_program

    cfg = serve_cfg(arch, layers, dtype=torch.float32)
    if cfg.kind not in ("ssm", "hybrid"):
        return None
    tok = torch.as_tensor(next(iter(SyntheticLM(cfg, DataConfig(
        seq_len=SERVE["prompt"], batch=SERVE["batch"]))))["tokens"],
        device="cuda").long()
    plain_attention = LY.flash_fwd_ref

    def prefill(chunk: int, kv_chunk: int | None = None) -> torch.Tensor:
        prog = build_program(dataclasses.replace(cfg, ssm_chunk=chunk), "1x1",
                             device="cuda", backend="torch")
        if kv_chunk:
            LY.flash_fwd_ref = functools.partial(plain_attention,
                                                 chunk=kv_chunk)
        try:
            return prog.model.prefill(tok)[0].float()
        finally:
            LY.flash_fwd_ref = plain_attention
            del prog
            free_card()

    base = prefill(cfg.ssm_chunk)
    out = {f"ssd chunk {cfg.ssm_chunk // 2}": float(
        (prefill(cfg.ssm_chunk // 2) - base).abs().max())}
    if cfg.kind == "hybrid":
        out["attention KV chunk 64"] = float(
            (prefill(cfg.ssm_chunk, 64) - base).abs().max())
    return out


def phase_serve() -> dict:
    """Both models served at full width and depth: timed on the kernels in
    bf16, then the f32 kernel route against the f32 plain route."""
    from repro_torch.configs import get_config

    return {arch: serve_arch(arch, {kern: get_config(arch).n_layers},
                             SERVE_LOGIT_TOL[arch])
            for arch, kern in SERVE_KERNEL.items()}


def serve_arch(arch: str, launches: dict, tol: float, bf16_runs: int = 2,
               layers: int | None = None,
               tie_tol: float | None = None) -> dict:
    """One model served at full width (``SERVE``), at full depth or its
    first ``layers`` layers: timed on the kernels in bf16 (each prefill
    launching each model kernel as often as ``launches`` says, nothing
    plain), then the f32 kernel route against the f32 plain route:
    prefill logits within ``tol``, the same greedy tokens; with
    ``tie_tol``, a sequence may part where both routes' top-2 gap is
    under ``tie_tol`` (a tie inside the routes' logit noise; its later
    tokens follow other inputs and are not compared).  One profiled bf16
    prefill.  ``launches`` in the result are the first bf16 run's."""
    from repro_torch.kernels import ops as K

    vocab = serve_cfg(arch).vocab
    cut = ("--layers", str(layers)) if layers else ()
    want = {k: launches.get(k, 0) for k in K.MODEL_KERNELS}
    runs = [serve_run(arch, *cut) for _ in range(bf16_runs)]
    for i, r in enumerate(runs):
        if r["launches"] != want or any(r["plain_calls"].values()):
            raise AssertionError(
                f"serve {arch} bf16 run {i}: launches {r['launches']} "
                f"(expected {want}), plain calls {r['plain_calls']}")
        log(f"[serve] {arch} bf16 run {i}: prefill {r['prefill_ms']} ms, "
            f"decode {r['decode_tok_per_s']} tok/s "
            f"({SERVE['gen'] - 1} steps in {r['decode_s']} s), launches "
            f"{r['launches']}, plain calls {r['plain_calls']}")
    kf = serve_run(arch, *cut, "--dtype", "float32")
    pf = serve_run(arch, *cut, "--dtype", "float32", "--backend", "torch")
    if kf["launches"] != want or any(kf["plain_calls"].values()) \
            or any(pf["launches"].values()):
        raise AssertionError(f"serve {arch} f32: kernel route launches "
                             f"{kf['launches']} plain {kf['plain_calls']};"
                             f" plain route launches {pf['launches']}")
    dlog = float((kf["prefill_logits"] - pf["prefill_logits"]).abs().max())
    reorder = reorder_control(arch, layers)
    top = float(pf["prefill_logits"][:, :vocab].abs().max())
    log(f"[serve] {arch} f32 kernels vs plain route: prefill logits max "
        f"abs {dlog} (tolerance {tol}; reordering the plain route's sums "
        f"alone: {reorder}; max |logit| {top}), prefill {kf['prefill_ms']} vs "
        f"{pf['prefill_ms']} ms")
    if not dlog <= tol:
        raise AssertionError(f"serve {arch}: f32 prefill logits differ by "
                             f"{dlog} > {tol}")
    diff = kf["tokens"] != pf["tokens"]
    ties = []
    for b in np.flatnonzero(diff.any(1)):
        j = int(np.flatnonzero(diff[b])[0])
        gaps = (float(kf["top2_gap"][j, b]), float(pf["top2_gap"][j, b]))
        if tie_tol is None or max(gaps) > tie_tol:
            raise AssertionError(
                f"serve {arch}: greedy token {j} of sequence {b} differs "
                f"(kernels {kf['tokens'][b, j]}, plain {pf['tokens'][b, j]});"
                f" top-2 logit gap there: kernels {gaps[0]}, plain "
                f"{gaps[1]}")
        ties.append({"sequence": int(b), "token": j, "top2_gap": gaps})
    same_toks = int(sum(int(np.flatnonzero(diff[b])[0]) if diff[b].any()
                        else diff.shape[1] for b in range(diff.shape[0])))
    log(f"[serve] {arch} f32: {same_toks} of {kf['tokens'].size} greedy "
        f"tokens the same on both routes; sequences that part at a top-2 "
        f"tie under {tie_tol} on both routes (token, gaps kernels / plain)"
        f": {ties}; smallest top-2 gap {float(pf['top2_gap'].min())}")
    out = {"bf16": runs, "f32": kf, "f32_plain": pf,
           "launches": runs[0]["launches"],
           "breakdown": serve_breakdown(arch, layers)}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the dense zoo configs: qwen2.5-3b and phi4-mini served and trained
# ---------------------------------------------------------------------------

# arch -> the trainer's depth on one card: about 22 bytes a parameter (bf16
# weights and gradient 4, AdamW's f32 moments 8, two ranks' bf16 gradient
# stacks 4, the synced sum, mean and clipped copies 6) plus one rank's
# activations must stay under 70 GiB (PERF.md section 4)
ZOO = {"qwen2.5-3b": 28, "phi4-mini-3.8b": 16}
ZOO_TRAIN = dict(n=2, batch=2, seq=512, steps=2)
ZOO_PEAK_GIB = 70.0


def direct_train(cfg, n: int, batch: int, seq: int, steps: int,
                 backend: str = "cuda") -> dict:
    """``cfg`` (cut to a depth, say) trained as ``launch/train.py`` would
    (``build_program`` + ``attach_train``, mesh ``n`` x 1 in this process,
    Zen, SyntheticLM batches of ``batch`` x ``seq`` tokens from seed 0) for
    ``steps`` steps on the ``backend`` route: losses, grad norms, words,
    overflow, an MoE model's ``moe/*`` stats, step seconds (host clock
    after a sync), tok/s, the kernel counts, parameters and peak memory."""
    from repro_torch.core.zen import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops as K
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prog = build_program(cfg, f"{n}x1", TrainerConfig(
        sync=SyncConfig(scheme="zen", backend=backend)), device="cuda",
        seed=0, backend=backend)
    attach_train(prog)
    params = sum(p.numel() for p in prog.model.parameters())
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=seq, batch=batch)))
    out = {k: [] for k in ("losses", "grad_norm", "sparse_words_by_step",
                           "overflow", "step_s")}
    K.reset_counts()
    t0 = time.time()
    for _ in range(steps):
        b = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in next(data).items()}
        torch.cuda.synchronize()
        t_step = time.time()
        m = prog.train_step(b)
        torch.cuda.synchronize()
        out["step_s"].append(time.time() - t_step)
        for k, key in (("losses", "loss"), ("grad_norm", "grad_norm"),
                       ("sparse_words_by_step", "sync/sparse_sent_words"),
                       ("overflow", "sync/overflow")):
            out[k].append(float(m[key]))
        for key in sorted(k for k in m if k.startswith("moe/")):
            out.setdefault(key, []).append(float(m[key]))
    out.update(launches=dict(K.LAUNCHES), plain=dict(K.PLAIN_CALLS),
               recompute=dict(K.RECOMPUTE_CALLS), params=params,
               tok_per_s=steps * batch * seq / (time.time() - t0),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del prog
    torch.cuda.empty_cache()
    return out


def zoo_train(arch: str, layers: int, backend: str) -> dict:
    """The arch at full width and ``layers`` deep, ``ZOO_TRAIN``'s mesh,
    batch and steps, Zen on ``embed/table`` on the ``backend`` route."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    z = ZOO_TRAIN
    return direct_train(cfg, z["n"], z["batch"], z["seq"], z["steps"],
                        backend)


def phase_zoo(smi: str) -> dict:
    """qwen2.5-3b and phi4-mini: served at full size (``serve_arch``: bf16
    timed, f32 kernels vs plain within 1e-3, the same greedy tokens, every
    prefill layer on ``flash_fwd`` at hd 128), then trained at full width
    and ``ZOO`` depth on 2 ranks: the kernel route bitwise its plain route
    (losses, grad norm, words), overflow 0, the Zen kernels once a rank a
    step, nothing plain, the peak under ``ZOO_PEAK_GIB``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K

    out = {}
    for arch, layers in ZOO.items():
        cfg = get_config(arch)
        log(f"[zoo] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads} q / {cfg.n_kv} KV heads of {cfg.hd}, vocab "
            f"{cfg.vocab} (padded {cfg.vocab_padded}), qkv_bias "
            f"{cfg.qkv_bias}, rope_theta {cfg.rope_theta}")
        served = serve_arch(arch, {"flash_fwd": cfg.n_layers}, 1e-3)
        runs = {b: zoo_train(arch, layers, b) for b in ("cuda", "torch")}
        run, plain = runs["cuda"], runs["torch"]
        for key in ("losses", "grad_norm", "sparse_words_by_step",
                    "overflow"):
            if run[key] != plain[key]:
                raise AssertionError(f"[zoo] {arch} trainer {key}: kernels "
                                     f"{run[key]} != plain {plain[key]}")
        steps = ZOO_TRAIN["steps"]
        check_launches(f"[zoo] {arch} trainer", run["launches"], run["plain"],
                       {k: steps * v for k, v in
                        K.path_launches(ZOO_TRAIN["n"]).items()})
        log(f"[zoo] {arch} trainer, {layers} of {cfg.n_layers} layers "
            f"({run['params'] / 1e9:.3f} B parameters), mesh "
            f"{ZOO_TRAIN['n']}x1, {ZOO_TRAIN['batch']} x {ZOO_TRAIN['seq']} "
            f"tokens: losses={run['losses']} grad_norm={run['grad_norm']} "
            f"words={run['sparse_words_by_step']} overflow={run['overflow']} "
            f"(plain route "
            f"bitwise) step_s={run['step_s']} (plain route {plain['step_s']})"
            f" peak {run['peak_gib']:.2f} GiB (plain route "
            f"{plain['peak_gib']:.2f}) launches {run['launches']} | {smi}")
        if not all(np.isfinite(run["losses"])) or any(run["overflow"]):
            raise AssertionError(f"[zoo] {arch} trainer: losses "
                                 f"{run['losses']} overflow {run['overflow']}")
        if max(run["peak_gib"], plain["peak_gib"]) > ZOO_PEAK_GIB:
            raise AssertionError(f"[zoo] {arch} trainer peak "
                                 f"{run['peak_gib']} GiB > {ZOO_PEAK_GIB}")
        out[arch] = {**served, "trainer": run}
    return out


# ---------------------------------------------------------------------------
# zamba2 and the MoE models: served and trained
# ---------------------------------------------------------------------------

# arch -> (served layers, trained layers, f32 serve tolerance).  One card
# holds zamba2 (1.17B parameters) and olmoe (6.92B: 27.7 GB in f32) whole;
# phi3.5-moe's 41.9B do not fit it even in bf16, so it serves its first 12
# of 32 layers (15.9B: 59.1 GiB in f32, one model resident at a time).  The
# trainers keep ZOO's rule (about 22 bytes a parameter plus one rank's
# activations under 70 GiB): olmoe 6 of 16 layers (2.72B), phi3.5-moe 2 of
# 32 (2.86B).  The f32 serve gates: zamba2's from SERVE_LOGIT_TOL, the MoE
# models' qwen2's.
HYBRID_MOE = {"zamba2-1.2b": (38, 38, SERVE_LOGIT_TOL["zamba2-1.2b"]),
              "olmoe-1b-7b": (16, 6, 1e-3),
              "phi3.5-moe-42b-a6.6b": (12, 2, 1e-3)}
MOE_STATS = ("moe/aux_loss", "moe/dropped", "moe/skew")
# zamba2's trainer losses, kernel route vs plain route (bf16): its scan
# runs on ssd_fwd on one route only, and the shared attention block carries
# that rounding on through the depth as in serving (0.0175 apart at step
# 0 on one H100, against mamba2_train's 5e-3 gate at 24 narrower layers)
HYBRID_LOSS_TOL = 5e-2
# the new prefill shapes (B 8, S 512): flash_fwd at each model's heads,
# ssd_fwd at zamba2's Mamba2 layer
HM_FLASH = {"zamba2-1.2b": dict(B=8, S=512, H=32, KV=32, hd=64),
            "olmoe-1b-7b": dict(B=8, S=512, H=16, KV=16, hd=128),
            "phi3.5-moe-42b-a6.6b": dict(B=8, S=512, H=32, KV=8, hd=128)}
HM_SSD = dict(B=8, S=512, H=64, hd=64, N=64, Q=64)


def prefill_launches(cfg) -> dict:
    """A hybrid or MoE prefill's model-kernel launches: one ``flash_fwd``
    an attention application (the hybrid's shared block once a group),
    one ``ssd_fwd`` a Mamba2 layer."""
    if cfg.kind == "hybrid":
        return {"flash_fwd": cfg.n_layers // cfg.shared_attn_every,
                "ssd_fwd": cfg.n_layers}
    return {"flash_fwd": cfg.n_layers}


def hybrid_moe_train(arch: str, layers: int, smi: str) -> dict:
    """``arch`` at full width and ``layers`` deep trained on ``ZOO_TRAIN``'s
    mesh, batch and steps on both routes: the MoE models' kernel route
    bitwise the plain route (losses, grad norm, words, overflow, the MoE
    stats; only the Zen kernels differ), zamba2's words and overflow
    bitwise and its losses within ``HYBRID_LOSS_TOL`` (its scan runs
    ``ssd_fwd`` on one route and the plain scan on the other; a plain run
    with the scan's chunk halved is logged beside, as a control); the Zen
    kernels once a rank a step, each Mamba2 layer's ``ssd_fwd`` once a
    rank a step with as many plain recomputes, nothing plain, the peak
    under ``ZOO_PEAK_GIB``."""
    from repro_torch.kernels import ops as K

    cfg = serve_cfg(arch, layers)
    z = ZOO_TRAIN
    runs = {b: direct_train(cfg, z["n"], z["batch"], z["seq"], z["steps"], b)
            for b in ("cuda", "torch")}
    run, plain = runs["cuda"], runs["torch"]
    keys = ("sparse_words_by_step", "overflow")
    if cfg.kind == "moe":
        keys += ("losses", "grad_norm") + MOE_STATS
    else:
        control = direct_train(dataclasses.replace(
            cfg, ssm_chunk=cfg.ssm_chunk // 2), z["n"], z["batch"], z["seq"],
            1, "torch")
        gap = max(abs(a - b) for a, b in zip(run["losses"], plain["losses"]))
        c0 = control["losses"][0]
        log(f"[hybrid_moe] {arch} trainer losses, kernels vs plain route: "
            f"{list(zip(run['losses'], plain['losses']))} (max difference "
            f"{gap}, tolerance {HYBRID_LOSS_TOL}); grad norms "
            f"{list(zip(run['grad_norm'], plain['grad_norm']))}; the plain "
            f"route with the scan's chunk {cfg.ssm_chunk // 2}: step-0 loss "
            f"{c0} ({abs(c0 - plain['losses'][0])} from the plain route)")
        if not gap <= HYBRID_LOSS_TOL:
            raise AssertionError(f"[hybrid_moe] {arch} trainer losses "
                                 f"{run['losses']} vs plain route "
                                 f"{plain['losses']}")
    for key in keys:
        if run[key] != plain[key]:
            raise AssertionError(f"[hybrid_moe] {arch} trainer {key}: "
                                 f"kernels {run[key]} != plain {plain[key]}")
    ranks_steps = z["n"] * z["steps"]
    want = {k: z["steps"] * v for k, v in K.path_launches(z["n"]).items()}
    scans = prefill_launches(cfg).get("ssd_fwd", 0) * ranks_steps
    if scans:
        want["ssd_fwd"] = scans
    check_launches(f"[hybrid_moe] {arch} trainer", run["launches"],
                   run["plain"], want)
    if run["recompute"]["ssd_fwd"] != scans \
            or any(plain["launches"].values()):
        raise AssertionError(f"[hybrid_moe] {arch} trainer: "
                             f"{run['recompute']} plain recomputes (expected "
                             f"{scans}); plain route launches "
                             f"{plain['launches']}")
    if not all(np.isfinite(run["losses"])) or any(run["overflow"]):
        raise AssertionError(f"[hybrid_moe] {arch} trainer: losses "
                             f"{run['losses']} overflow {run['overflow']}")
    stats = {k: run[k] for k in MOE_STATS if k in run}
    log(f"[hybrid_moe] {arch} trainer, {layers} of "
        f"{serve_cfg(arch).n_layers} layers ({run['params'] / 1e9:.3f} B "
        f"parameters), mesh {z['n']}x1, {z['batch']} x {z['seq']} tokens: "
        f"losses={run['losses']} grad_norm={run['grad_norm']} "
        f"words={run['sparse_words_by_step']} overflow={run['overflow']} "
        f"{stats} (plain route {'bitwise' if cfg.kind == 'moe' else 'above'})"
        f" step_s={run['step_s']} (plain "
        f"route {plain['step_s']}) peak {run['peak_gib']:.2f} GiB (plain "
        f"route {plain['peak_gib']:.2f}) launches {run['launches']} "
        f"recomputes {run['recompute']} | {smi}")
    if max(run["peak_gib"], plain["peak_gib"]) > ZOO_PEAK_GIB:
        raise AssertionError(f"[hybrid_moe] {arch} trainer peak "
                             f"{run['peak_gib']} GiB > {ZOO_PEAK_GIB}")
    return {"kernels": run, "plain": plain}


def hybrid_moe_kernel_shapes(smi: str) -> dict:
    """``flash_fwd`` (bf16) at the three models' prefill heads and
    ``ssd_fwd`` (f32) at zamba2's Mamba2 layer: two kernel calls bitwise
    equal, each within its stated tolerance of the plain version (one
    bf16 ulp; ``SSD_TOL``), then timed beside SDPA and the bound (rows
    9d-9f, 10b)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as K, ref as R

    err = {"flash_fwd": 0.0, "ssd_fwd": 0.0}
    rows = []
    for (arch, shp), tag in zip(HM_FLASH.items(), "def"):
        q, k, v = flash_inputs(torch.bfloat16, **shp)
        got = K.flash_fwd_op(q, k, v)
        same([K.flash_fwd_op(q, k, v)], [got],
             f"flash_fwd {arch}: second call")
        want = R.flash_fwd_ref(q, k, v)
        diff = (got.float() - want.float()).abs()
        worst = float(diff.max())
        if not bool((diff <= bf16_ulp(want) + 1e-6).all()):
            raise AssertionError(f"flash_fwd {arch} {shp}: differs from the "
                                 f"plain version by more than one bf16 ulp "
                                 f"(max abs {worst})")
        err["flash_fwd"] = max(err["flash_fwd"], worst)
        log(f"[hybrid_moe] flash_fwd {arch} {shp}: two calls bitwise equal, "
            f"max abs {worst} from the plain version, within one bf16 ulp")
        B, S, H, hd = q.shape
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = time_row(
            f"flash_fwd ({arch}, {H} / {k.shape[2]} heads of {hd})",
            lambda: K.flash_fwd_op(q, k, v),
            lambda: R.flash_fwd_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4 * (B * H * S * (S + 1) // 2) * hd, BF16_OPS_PER_S, smi)
        rows.append({**row, "kernel": "flash_fwd", "row": f"9{tag}"})
        del q, k, v, qt, kt, vt, got, want
    c = HM_SSD
    x, dA, Bm, Cm = ssd_scan_inputs(*ssd_inputs(c["B"], c["S"], c["H"],
                                                c["hd"], c["N"])[:5])
    got = K.ssd_fwd_op(x, dA, Bm, Cm, chunk=c["Q"])
    same(K.ssd_fwd_op(x, dA, Bm, Cm, chunk=c["Q"]), got,
         "ssd_fwd zamba2: second call")
    want = R.ssd_fwd_ref(x, dA, Bm, Cm, chunk=c["Q"])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=SSD_TOL, rtol=SSD_TOL)
    err["ssd_fwd"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"[hybrid_moe] ssd_fwd zamba2 {c}: two calls bitwise equal, max abs "
        f"{err['ssd_fwd']} from the plain version, within {SSD_TOL}")
    Q, tri, nc = c["Q"], c["Q"] * (c["Q"] + 1) // 2, c["S"] // c["Q"]
    ssd_ops = c["B"] * nc * (2 * tri * c["N"] + c["H"] * (
        2 * tri * c["hd"] + 4 * Q * c["N"] * c["hd"]))
    nbytes = 4 * (2 * x.numel() + dA.numel() + Bm.numel() + Cm.numel()
                  + c["B"] * c["H"] * c["hd"] * c["N"])
    row = time_row(
        f"ssd_fwd (zamba2-1.2b, {c['H']} heads of {c['hd']}, N {c['N']})",
        lambda: K.ssd_fwd_op(x, dA, Bm, Cm, chunk=Q),
        lambda: R.ssd_fwd_ref(x, dA, Bm, Cm, chunk=Q), None, nbytes, ssd_ops,
        OPS_PER_S, smi)
    row["bound_split_ms"] = bound(nbytes, ssd_ops, TF32_OPS_PER_S / 3)[0]
    log(f"[hybrid_moe] ssd_fwd zamba2: bound at the split TF32 rate "
        f"{row['bound_split_ms']:.6f} ms, at the f32 FMA rate "
        f"{row['bound_ms']:.6f} ms")
    rows.append({**row, "kernel": "ssd_fwd", "row": "10b"})
    return {"err": err, "rows": rows}


def phase_hybrid_moe(smi: str) -> dict:
    """zamba2-1.2b, olmoe-1b-7b and phi3.5-moe-42b-a6.6b served
    (``serve_arch`` at the depths and tolerances ``HYBRID_MOE`` sets, the
    launches ``prefill_launches`` counts) and trained
    (``hybrid_moe_train``), one model on the card at a time; then the
    prefill kernels at the models' new shapes."""
    out = {}
    for arch, (serve_layers, train_layers, tol) in HYBRID_MOE.items():
        full = serve_cfg(arch)
        cfg = serve_cfg(arch, serve_layers)
        log(f"[hybrid_moe] {arch} ({full.kind}): {full.n_layers} layers, d "
            f"{full.d_model}, {full.n_heads} q / {full.n_kv} KV heads of "
            f"{full.hd}, d_ff {full.d_ff}, vocab {full.vocab}, experts "
            f"{full.n_experts} top-{full.top_k}, ssm_state {full.ssm_state}, "
            f"shared attention every {full.shared_attn_every}; served at "
            f"{serve_layers} layers, trained at {train_layers}")
        cut = serve_layers if serve_layers != full.n_layers else None
        # zamba2's tokens may part at a tie inside its logit gate
        served = serve_arch(arch, prefill_launches(cfg), tol, layers=cut,
                            tie_tol=tol if cfg.kind == "hybrid" else None)
        out[arch] = {**served,
                     "trainer": hybrid_moe_train(arch, train_layers, smi)}
    return {"models": out, **hybrid_moe_kernel_shapes(smi)}


# ---------------------------------------------------------------------------
# the Mamba2 trainer: ssd_fwd under autograd
# ---------------------------------------------------------------------------

# mamba2-370m at full width, 8 x 512 tokens; 24 of its 48 layers keep the
# whole smoke inside its time limit (the phase took 351 s at full depth)
MAMBA_TRAIN = dict(n=8, batch=8, seq=512, layers=24)


def mamba_cfg():
    """mamba2-370m at full width, cut to ``MAMBA_TRAIN['layers']``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("mamba2-370m"),
                               n_layers=MAMBA_TRAIN["layers"])


def ssd_scan_grads_check() -> None:
    """``SSDScan`` at one rank's training shape (Bt 1, S 512, 32 heads of
    64, N 128, Q 64): its gradients of x, dA, Bm and Cm bitwise those of
    autograd through ``ref.ssd_fwd_ref`` on the same inputs and upstream
    gradient (the same computation); its y within SSD_TOL of the plain
    one."""
    from repro_torch.kernels import ops as K, ref as R

    c = SSD
    raw = ssd_inputs(1, c["S"], c["H"], c["hd"], c["N"])
    scan = ssd_scan_inputs(*raw[:5])
    gy = torch.randn((1, c["S"], c["H"], c["hd"]), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    K.reset_counts()
    ins = [t.detach().clone().requires_grad_() for t in scan]
    y, _ = K.SSDScan.apply(*ins, c["Q"])
    got = torch.autograd.grad([y], ins, [gy])
    ref_ins = [t.detach().clone().requires_grad_() for t in scan]
    ry, _ = R.ssd_fwd_ref(*ref_ins, chunk=c["Q"])
    want = torch.autograd.grad([ry], ref_ins, [gy])
    torch.cuda.synchronize()
    if (K.LAUNCHES["ssd_fwd"], K.RECOMPUTE_CALLS["ssd_fwd"],
            K.PLAIN_CALLS["ssd_fwd"]) != (1, 1, 0):
        raise AssertionError(f"SSDScan: launches {K.LAUNCHES['ssd_fwd']}, "
                             f"recomputes {K.RECOMPUTE_CALLS['ssd_fwd']}, "
                             f"plain {K.PLAIN_CALLS['ssd_fwd']}")
    for name, a, b in zip(("x", "dA", "Bm", "Cm"), got, want):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"SSDScan's gradient of {name} differs from "
                                 f"autograd through ssd_fwd_ref (max abs "
                                 f"{float((a - b).abs().max())})")
    torch.testing.assert_close(y, ry, atol=SSD_TOL, rtol=SSD_TOL)
    log(f"[mamba2_train] SSDScan at (1, {c['S']}, {c['H']}, {c['hd']}, "
        f"N {c['N']}): grads of x, dA, Bm, Cm bitwise autograd through "
        f"ssd_fwd_ref; y max abs vs plain {float((y - ry).abs().max())}")


def mamba2_repeated_batch(smi: str, steps: int = 10) -> list[float]:
    """The Mamba2 trainer (1x1, the launcher's lr) for ``steps`` steps on
    one repeated batch of 8 x 512 tokens, its scan under ``SSDScan``: every
    loss finite (the plain scan's gradient once went NaN here, at step 4,
    when a chunk's decay span passed exp's range).  The losses are logged,
    not required to fall: at full depth this init's loss moves by noise
    over ten steps, fresh batches or one (the reference's trainer shows
    the same at 12 layers)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program

    cfg = mamba_cfg()
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in next(iter(SyntheticLM(cfg, DataConfig(
                 seq_len=MAMBA_TRAIN["seq"],
                 batch=MAMBA_TRAIN["batch"])))).items()}
    prog = build_program(cfg, "1x1", device="cuda")
    attach_train(prog)
    metrics = [prog.train_step(batch) for _ in range(steps)]
    losses = [float(m["loss"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    del prog, metrics
    torch.cuda.empty_cache()
    log(f"[mamba2_train] one batch repeated, 1x1: losses={losses} "
        f"grad_norm={gnorm} | {smi}")
    if not all(np.isfinite(losses + gnorm)):
        raise AssertionError(f"mamba2 trainer on one repeated batch: "
                             f"losses {losses}, grad norms {gnorm}")
    return losses


def mamba2_breakdown() -> dict:
    """One profiled step (after a warm-up step) of the mamba2 trainer:
    device ms by category, ``ssd_fwd``'s kernels' ms, idle share."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program

    m = MAMBA_TRAIN
    cfg = mamba_cfg()
    prog = build_program(cfg, f"{m['n']}x1", device="cuda")
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=m["seq"],
                                            batch=m["batch"])))
    batches = [{k: torch.as_tensor(v, device="cuda").long()
                for k, v in next(data).items()} for _ in range(2)]
    prog.train_step(batches[0])
    out = device_breakdown(lambda: prog.train_step(batches[1]),
                           "mamba2_train")
    out["ssd_fwd_ms"] = sum(ms for nm, ms in out["by_name"].items()
                            if "ssd_fwd" in nm)
    del prog
    torch.cuda.empty_cache()
    return out


def phase_mamba2_train(smi: str, steps: int = 4) -> dict:
    """The mamba2-370m trainer, mesh 8x1, at full width and
    ``MAMBA_TRAIN['layers']`` deep: finite loss, no overflow, ``ssd_fwd``
    launched layers x 8 x steps times (the forward of every layer of every
    rank) and its plain recompute as often (``SSDScan``'s backward), Zen's
    kernels 8 x steps times, nothing plain; held to the plain route;
    ``SSDScan``'s gradients bitwise the plain scan's; ten finite steps on
    one repeated batch; step time, peak memory, a profiled step."""
    from repro_torch.kernels import ops as K

    m = MAMBA_TRAIN
    n_layers = m["layers"]
    res = direct_train(mamba_cfg(), m["n"], m["batch"], m["seq"], steps)
    res["overflow"] = max(res["overflow"])
    peak = res["peak_gib"] * 2**30
    launches = dict(res["launches"])
    recompute = res["recompute"]["ssd_fwd"]
    want = {k: steps * v for k, v in K.path_launches(m["n"]).items()}
    want["ssd_fwd"] = n_layers * m["n"] * steps
    check_launches("mamba2_train", launches, res["plain"], want)
    if recompute != want["ssd_fwd"]:
        raise AssertionError(f"mamba2_train: {recompute} plain recomputes, "
                             f"expected {want['ssd_fwd']}")
    losses = res["losses"]
    log(f"[mamba2_train] kernels: losses={losses} sparse_words="
        f"{res['sparse_words_by_step']} overflow={res['overflow']} "
        f"step_s={res['step_s']} tok/s={res['tok_per_s']} peak memory "
        f"{peak} B; launches {launches}, recomputes {recompute} | {smi}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"mamba2 trainer loss not finite: {losses}")
    if res["overflow"] != 0:
        raise AssertionError(f"mamba2 trainer overflow {res['overflow']}")
    plain = direct_train(mamba_cfg(), m["n"], m["batch"], m["seq"], steps,
                         "torch")
    log(f"[mamba2_train] {n_layers} of 48 layers; losses, kernels vs plain "
        f"route: "
        f"{list(zip(losses, plain['losses']))}; plain step_s="
        f"{plain['step_s']} tok/s={plain['tok_per_s']}")
    if abs(losses[0] - plain["losses"][0]) > 5e-3:
        raise AssertionError(f"mamba2 step-0 loss {losses[0]} vs plain "
                             f"route {plain['losses'][0]}")
    if res["sparse_words_by_step"] != plain["sparse_words_by_step"]:
        raise AssertionError(f"mamba2 wire words differ from the plain "
                             f"route: {res['sparse_words_by_step']} vs "
                             f"{plain['sparse_words_by_step']}")
    torch.cuda.empty_cache()
    ssd_scan_grads_check()
    mamba2_repeated_batch(smi)
    bd = mamba2_breakdown()
    log(f"[mamba2_train] median step s after the first "
        f"{np.median(res['step_s'][1:])} (plain route "
        f"{np.median(plain['step_s'][1:])}); tok/s {res['tok_per_s']}; "
        f"peak memory {peak / 2**30:.2f} GiB; profiled step: ssd_fwd "
        f"{bd['ssd_fwd_ms']:.3f} device ms, idle share {bd['idle_share']} "
        f"| {smi}")
    return {**res, "launches": launches, "recompute": recompute}


def phase_serve_times(inp: dict, smi: str) -> list:
    """Rows 9 and 10 at the serve shapes: kernel, plain version, library
    (SDPA for attention; nothing computes the SSD scan), and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as K, ref as R

    q, k, v = inp["flash"]
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    pairs = B * H * S * (S + 1) // 2        # causal (query, key) pairs
    x, dA, Bm, Cm = inp["ssd"]
    Bt, Ss, Hs, hds = x.shape
    N, Q = Bm.shape[-1], SSD["Q"]
    tri, nc = Q * (Q + 1) // 2, Ss // Q
    # per chunk: C B^T once per sequence (ngroups = 1; its lower triangle);
    # per head the masked product with x, C S^T and the state update
    ssd_ops = Bt * nc * (2 * tri * N + Hs * (2 * tri * hds + 4 * Q * N * hds))
    rows = {
        "flash_fwd": (
            lambda: K.flash_fwd_op(q, k, v),
            lambda: R.flash_fwd_ref(q, k, v),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4 * pairs * hd, BF16_OPS_PER_S, sdpa),
        "ssd_fwd": (
            lambda: K.ssd_fwd_op(x, dA, Bm, Cm, chunk=Q),
            lambda: R.ssd_fwd_ref(x, dA, Bm, Cm, chunk=Q),
            4 * (2 * x.numel() + dA.numel() + Bm.numel() + Cm.numel()
                 + Bt * Hs * hds * N), ssd_ops, OPS_PER_S, None),
    }
    res = []
    for name, (kern, plain, nbytes, nops, rate, lib) in rows.items():
        res.append(time_row(name, kern, plain, lib, nbytes, nops, rate, smi))
    # ssd_fwd's products run on the TF32 tensor cores with each operand
    # split in two, three products for one: the same counted work at a
    # third of the TF32 rate
    split_ms = bound(rows["ssd_fwd"][2], ssd_ops, TF32_OPS_PER_S / 3)[0]
    res[-1]["bound_split_ms"] = split_ms
    log(f"[times] ssd_fwd: bound at the split TF32 rate (495/3 TFLOP/s) "
        f"{split_ms:.6f} ms, at the f32 FMA rate {res[-1]['bound_ms']:.6f} ms")
    return res


def time_row(name, kern, plain, lib, nbytes, nops, rate, smi,
             plain_iters: int = 20) -> dict:
    """One row of the kernel table: the kernel's, its plain version's and
    the library call's times (``cuda_time_ms``; the plain version over
    ``plain_iters`` calls), the kernel's and the library call's device
    times (``cuda_device_ms``), and the bound."""
    bound_ms, bound_by = bound(nbytes, nops, rate)
    ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain, plain_iters)
    lib_ms = cuda_time_ms(lib) if lib is not None else None
    dev_ms = cuda_device_ms(kern)
    lib_dev_ms = cuda_device_ms(lib) if lib is not None else None
    log(f"[times] {name}: {ms:.4f} ms, device {dev_ms} ms (plain "
        f"{plain_ms:.4f} ms, library {lib_ms} ms, device {lib_dev_ms} ms, "
        f"bound {bound_ms:.6f} ms by {bound_by} from {nbytes} B / {nops} "
        f"ops at {rate:.3g}/s) | {smi}")
    return {"name": name, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "bytes": nbytes, "ops": nops}


def bound(nbytes: int, nops: int = 0,
          ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the compute rate for their
    type, in ms."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def flash_wide_times(smi: str) -> list:
    """Informational, beside the table: ``flash_fwd`` in bf16 at the
    qwen2.5-3b (hd 128) and pixtral-12b (hd 160) prefills against SDPA
    (``is_causal``, ``enable_gqa``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as K, ref as R

    res = []
    for arch, shp in FLASH_WIDE.items():
        q, k, v = flash_inputs(torch.bfloat16, **shp)
        B, S, H, hd = q.shape
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * H * S * (S + 1) // 2
        res.append(time_row(
            f"flash_fwd ({arch}, hd {hd})",
            lambda: K.flash_fwd_op(q, k, v),
            lambda: R.flash_fwd_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4 * pairs * hd, BF16_OPS_PER_S, smi))
        del q, k, v, qt, kt, vt
    return res


def scatter_dense_times(dense: dict, smi: str) -> dict:
    """Informational, beside the table: the scatter-add at phase 2's dense
    stream near capacity (server 0), against ``index_add_`` on its live
    rows."""
    from repro_torch.kernels import ops as K, ref as R

    lp, vals, lo = dense["lp"], dense["vals"], dense["lo"]
    d, el = vals.shape[1], vals.element_size()
    out = torch.zeros((lo.cap_server, d), dtype=vals.dtype, device=vals.device)
    keep = lp < lo.cap_server
    lib_idx, lib_vals = lp[keep].long(), vals[keep]
    live, touched = int(keep.sum()), int(torch.unique(lp[keep]).numel())
    log(f"[times] coo_scatter_add dense stream: C={lp.numel()} live rows="
        f"{live} touched targets={touched}")
    return time_row(
        "coo_scatter_add (dense stream)",
        lambda: K.coo_scatter_add_op(out, lp, vals),
        lambda: R.coo_scatter_add_ref(out, lp, vals),
        lambda: out.index_add_(0, lib_idx, lib_vals),
        lp.numel() * 4 + live * d * el + 2 * touched * d * el, live * d,
        OPS_PER_S, smi)


def push_dense_times(dense: dict, smi: str) -> dict:
    """Informational, beside the table: the commit push at phase 2's dense
    stream (row density 0.2, server 0; more slots survive than cap_pull
    takes), its bound counted as in the table's row."""
    from repro_torch.kernels import ops as K, ref as R

    lp, vals, lo = dense["lp"], dense["vals"], dense["lo"]
    L, d, el = lo.cap_pull, vals.shape[1], vals.element_size()
    live = int((lp < lo.cap_server).sum())
    log(f"[times] zen_commit_push dense stream: C={lp.numel()} live rows="
        f"{live} touched slots="
        f"{int(torch.unique(lp[lp < lo.cap_server]).numel())}")
    return time_row(
        "zen_commit_push (dense stream)",
        lambda: K.zen_commit_push_fused_op(
            lp, vals, cap_server=lo.cap_server, cap_pull=L),
        lambda: R.zen_commit_push_ref(
            lp, vals, cap_server=lo.cap_server, cap_pull=L),
        None, lp.numel() * 4 + live * d * el + L * (4 + d * el)
        + lo.cap_bitmap_words * 4 + 4, live * d, OPS_PER_S, smi)


def launch_split(fn, tag: str, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` by kernel (and memset) name, from
    torch.profiler over ``reps`` calls: where a multi-launch call's time
    goes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    log(f"[times] {tag} by launch, device us a call (torch.profiler, "
        f"{reps} calls): total {sum(us.values()):.3f}")
    for name, t in sorted(us.items(), key=lambda kv: -kv[1]):
        log(f"[times]   {t:9.3f} us  {name[:100]}")
    return us


def encode_dense_times(dense: dict, smi: str) -> dict:
    """Informational, beside the table: the encode at phase 2's dense
    stream (row density 0.2, worker 0)."""
    from repro_torch.kernels import ops as K, ref as R

    idx, lo = dense["idx"], dense["lo"]
    n, L, seeds = lo.n, lo.cap_pull, lo.static_seeds()
    W = -(-L // 32)
    log(f"[times] zen_encode dense stream: C={idx.numel()} live="
        f"{int((idx != 2**31 - 1).sum())}")
    return time_row(
        "zen_encode (dense stream)",
        lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
        lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
        None, idx.numel() * 4 + (n * (L + W) + 1) * 4, 0, OPS_PER_S,
        smi)


def hash_ops(idx: torch.Tensor, k: int) -> int:
    """The hash stage's integer operations on this index vector: per live
    index k+1 hashes of 2 fmix32 rounds (8 ops each), 2 xors and a modulo;
    an EMPTY index needs none (it maps to the sentinels)."""
    return int((idx != 2**31 - 1).sum()) * (k + 1) * 19


def unfused_dense_times(dense: dict, smi: str) -> list:
    """Informational, beside the table: the hash stage and the row
    compaction at phase 2's dense stream (worker 0's index vector and its
    Alg. 1 memory), their bounds counted as in the table's rows, and each
    kernel's device time under torch.profiler."""
    from repro_torch.kernels import ops as K, ref as R

    idx, mem, lo = dense["idx"], dense["mem"], dense["lo"]
    seeds = lo.static_seeds()
    k = len(seeds) - 1
    log(f"[times] hash_stage / row_compact dense stream: C={idx.numel()} "
        f"live={int((idx != 2**31 - 1).sum())}, mem {tuple(mem.shape)} live="
        f"{int((mem != 2**31 - 1).sum())}")
    rows = [time_row(
        "hash_stage (dense stream)",
        lambda: K.hash_stage_op(idx, seeds, lo.n, lo.r1),
        lambda: R.hash_stage_ref(idx, seeds, lo.n, lo.r1),
        None, idx.numel() * 4 * (2 + k), hash_ops(idx, k), OPS_PER_S, smi),
        time_row(
        "row_compact (dense stream)",
        lambda: K.row_compact_op(mem), lambda: R.row_compact_ref(mem),
        None, 2 * mem.numel() * 4, 0, OPS_PER_S, smi)]
    launch_split(lambda: K.hash_stage_op(idx, seeds, lo.n, lo.r1),
                 "hash_stage (dense stream)")
    launch_split(lambda: K.row_compact_op(mem), "row_compact (dense stream)")
    return rows


def phase_times(inp: dict, smi: str) -> list:
    from repro_torch.kernels import ops as K, ref as R

    lo, idx, lp, vals, bms, mem = (inp[k] for k in (
        "lo", "idx", "lp", "vals", "bms", "mem"))
    n, L, d = lo.n, lo.cap_pull, vals.shape[1]
    W = -(-L // 32)
    live = int((lp < lo.cap_server).sum())
    touched = int(torch.unique(lp[lp < lo.cap_server]).numel())
    el = vals.element_size()
    seeds = lo.static_seeds()
    C, k = idx.numel(), len(seeds) - 1
    masks = inp["masks"]
    out = torch.zeros((lo.cap_server, d), dtype=vals.dtype,
                      device=vals.device)
    keep = lp < lo.cap_server
    lib_idx, lib_vals = lp[keep].long(), vals[keep]
    rows = {
        "zen_encode": (
            lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
            lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
            C * 4 + (n * (L + W) + 1) * 4, 0, None),
        "zen_commit_push": (
            lambda: K.zen_commit_push_fused_op(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lambda: R.zen_commit_push_ref(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lp.numel() * 4 + live * d * el + L * (4 + d * el)
            + lo.cap_bitmap_words * 4 + 4, live * d, None),
        "zen_commit_pull": (
            lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
            lambda: R.zen_commit_pull_ref(bms, lo.cap_server, L),
            bms.numel() * 4 + n * L * 4, 0, None),
        "hash_stage": (
            lambda: K.hash_stage_op(idx, seeds, n, lo.r1),
            lambda: R.hash_stage_ref(idx, seeds, n, lo.r1),
            C * 4 * (2 + k), hash_ops(idx, k), None),
        "row_compact": (
            lambda: K.row_compact_op(mem),
            lambda: R.row_compact_ref(mem),
            2 * mem.numel() * 4, 0, None),
        "coo_scatter_add": (
            lambda: K.coo_scatter_add_op(out, lp, vals),
            lambda: R.coo_scatter_add_ref(out, lp, vals),
            lp.numel() * 4 + live * d * el + 2 * touched * d * el, live * d,
            lambda: out.index_add_(0, lib_idx, lib_vals)),
        "bitmap_pack": (     # every server's mask, one pack a sync
            lambda: K.bitmap_pack_rows_op(masks),
            lambda: R.bitmap_pack_rows_ref(masks),
            masks.numel() + bms.numel() * 4, 0, None),
        "bitmap_unpack": (   # one worker's pull: [n, W] -> [n, cap_server]
            lambda: K.bitmap_unpack_rows_op(bms, lo.cap_server),
            lambda: R.bitmap_unpack_rows_ref(bms, lo.cap_server),
            bms.numel() * 4 + n * lo.cap_server, 0, None),
    }
    res = []
    for name, (kern, plain, nbytes, nops, lib) in rows.items():
        res.append(time_row(name, kern, plain, lib, nbytes, nops, OPS_PER_S,
                            smi))
    log(f"[times] zen_commit_push stream: C={lp.numel()} live rows={live} "
        f"touched slots={touched}")
    launch_split(lambda: K.hash_stage_op(idx, seeds, n, lo.r1), "hash_stage")
    launch_split(lambda: K.row_compact_op(mem), "row_compact")
    launch_split(lambda: K.zen_commit_push_fused_op(
        lp, vals, cap_server=lo.cap_server, cap_pull=L), "zen_commit_push")
    launch_split(lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
                 "zen_commit_pull")
    grid, kept = K.zen_commit_push_grid(lp, vals, cap_server=lo.cap_server,
                                        cap_pull=L)
    log(f"[times] zen_commit_push: cooperative grid of {grid} blocks of 256 "
        f"threads ({vals.dtype}, d {d}), kept scratch {kept} B for the "
        f"stream")
    sa = K._lib("scatter_add")
    fit = sa.scatter_add_resident_blocks(K._DTYPE_CODE[vals.dtype], d,
                                         vals.data_ptr(), out.data_ptr())
    log(f"[times] coo_scatter_add: cooperative grid of {fit} co-resident "
        f"blocks of 256 threads ({vals.dtype}, d {d}), capped by the "
        f"stream's rows and targets")
    return res


def bitmap_inputs(dev) -> dict:
    """Phase 2's realistic and dense streams (the same seed and draws) as
    ``kernel_inputs`` gives them, for the bitmap call sites."""
    from repro_torch.core import schemes as S

    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    rng = np.random.default_rng(0)
    g = zipf_rows(rng, n, M, SLICE["tokens"], d, torch.bfloat16, dev)
    out = {"realistic": dict(kernel_inputs(g, lo), lo=lo)}
    del g
    g = dense_rows(rng, n, M, 0.2, d, torch.bfloat16, dev)
    out["dense"] = dict(kernel_inputs(g, lo), lo=lo)
    del g
    torch.cuda.empty_cache()
    return out


def bitmap_times(streams: dict, smi: str) -> dict:
    """The bitmap pair at its call sites, each timed by ``cuda_device_ms``
    and under torch.profiler (``launch_split``), beside a ``zero_()`` of
    the call's own output bytes (the floor of one launch that writes
    them): the unfused commit's server masks [n, cap_server] packed as n
    1-D calls and a stack, and as one row call; the unfused encode's
    occupancy [n, r1 + r2]; the pull's unpack of the gathered [n, W] words
    into [n, cap_server] (``formats.bitmap_decode_batch``) and as one row
    of all n W words.  Only the 1-D and row wrappers are called, so an
    older checkout of the port is timed the same way."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops as K

    res = {}

    def timed(tag, fn):
        dev_ms = cuda_device_ms(fn)
        us = launch_split(fn, tag)
        res[tag] = {"device_ms": dev_ms, "us": us,
                    "total_us": sum(us.values())}
        log(f"[bitmap_times] {tag}: device_ms {dev_ms} | {smi}")

    for sname, inp in streams.items():
        masks, occ, bms = (inp[k] for k in ("masks", "occ", "bms"))
        n, cap = masks.shape
        flat = bms.reshape(-1)
        calls = {
            "server pack, n 1-D calls + stack": lambda: torch.stack(
                [K.bitmap_pack_op(masks[s]) for s in range(n)]),
            "server pack, rows": lambda: K.bitmap_pack_rows_op(masks),
            "encode pack, rows": lambda: K.bitmap_pack_rows_op(occ),
            "pull unpack, rows": lambda: F.bitmap_decode_batch(
                bms, cap, backend="cuda"),
            "pull unpack, all words as one row": lambda: K.bitmap_unpack_op(
                flat, flat.numel() * 32),
        }
        for cname, fn in calls.items():
            timed(f"{sname} {cname}", fn)
        for cname, fn in calls.items():
            z = torch.empty_like(fn())
            timed(f"{sname} zero_() of {cname}'s output "
                  f"({z.numel() * z.element_size()} B)", z.zero_)
    log(f"[bitmap_times] json {json.dumps(res)}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases to run (debugging); default "
                         "all: kernels (with kernels_wide and new_shapes),"
                         "zen_sync,trainer,breakdown,buckets,overlap,"
                         "serve_kernels,serve,mamba2_train,compress,schemes,"
                         "hier,zoo,hybrid_moe,dist,times "
                         "(bitmap_times: the "
                         "bitmap call sites alone; dist_hier: the dist "
                         "trainer on nodes of 2 ranks alone; dist_parts: the dist "
                         "trainers' step parts; dist_nccl: the dist trainer "
                         "over nccl on four cards; dist_sync: dist's "
                         "gloo zen_sync and schemes check alone; none of "
                         "these in the default run)")
    ap.add_argument("--dist-rank", nargs=2, default=None,
                    metavar=("JOB", "DIR"),
                    help=argparse.SUPPRESS)   # one rank of phase 8 (torchrun)
    args = ap.parse_args(argv)
    if args.dist_rank:
        dist_rank(args.dist_rank[0], Path(args.dist_rank[1]))
        return
    only = set(filter(None, args.only.split(",")))
    want = (lambda p: not only or p in only)
    t_start = time.time()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.time()
        log(f"[phase] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    dev_info = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build(verbose=True)   # every kernel, one nvcc per source at once
    log(f"[build] {len(_build.SOURCES)} libraries in {time.time() - t0:.1f}s")
    phase_done("build")
    if want("dist"):   # first: four full-width ranks share this card
        phase_dist(dev, dev_info["smi"])
        phase_done("dist")
    else:
        if "dist_sync" in only:
            dist_zen_sync(dev)
            phase_done("dist_sync")
        if "dist_hier" in only:
            dist_trainer("gloo", dev_info["smi"], variants=DIST_VARIANTS[2:])
            phase_done("dist_hier")
    # zoo next: its trainers fill most of the card, before other phases
    # leave kernel scratch and cached blocks behind
    zoo = phase_zoo(dev_info["smi"]) if want("zoo") else None
    phase_done("zoo")
    # the same for zamba2 and the MoE models (phi3.5-moe's trainer alone
    # needs about 60 GiB)
    hybrid_moe = phase_hybrid_moe(dev_info["smi"]) if want("hybrid_moe") \
        else None
    phase_done("hybrid_moe")
    kern = phase_kernels(dev) if want("kernels") or want("times") else None
    wide = (phase_kernels_wide(dev, dev_info["smi"], timed=want("times"))
            if want("kernels") or want("times") or "kernels_wide" in only
            else None)
    shapes = (phase_new_shapes(dev, dev_info["smi"], timed=want("times"))
              if want("kernels") or want("times") or "new_shapes" in only
              else None)
    phase_done("kernels")
    if want("zen_sync"):
        phase_zen_sync(dev)
        phase_done("zen_sync")
    trainer = phase_trainer() if want("trainer") else None
    phase_done("trainer")
    if want("breakdown"):
        phase_breakdown()
        phase_done("breakdown")
    bucketed = phase_buckets(dev_info["smi"]) if want("buckets") else None
    phase_done("buckets")
    if want("overlap"):
        phase_overlap(dev, dev_info["smi"])
        phase_done("overlap")
    skern = phase_serve_kernels() if want("serve_kernels") or want("times") \
        else None
    phase_done("serve_kernels")
    served = phase_serve() if want("serve") else None
    phase_done("serve")
    mamba = phase_mamba2_train(dev_info["smi"]) if want("mamba2_train") \
        else None
    phase_done("mamba2_train")
    compressed = phase_compress(dev_info["smi"]) if want("compress") \
        else None
    phase_done("compress")
    schemes = phase_schemes(dev_info["smi"], trainer) if want("schemes") \
        else None
    phase_done("schemes")
    hier = phase_hier(dev_info["smi"], trainer) if want("hier") else None
    phase_done("hier")
    if "dist_parts" in only:
        dist_step_parts(DIST_TRAIN_RANKS, dev_info["smi"])
    if "dist_nccl" in only:
        dist_trainer("nccl", dev_info["smi"])
    times = []
    if want("times"):
        times = phase_times(kern["inputs"], dev_info["smi"]) \
            + phase_serve_times(skern, dev_info["smi"])
        scatter_dense_times(kern["dense"], dev_info["smi"])
        encode_dense_times(kern["dense"], dev_info["smi"])
        push_dense_times(kern["dense"], dev_info["smi"])
        unfused_dense_times(kern["dense"], dev_info["smi"])
        flash_wide_times(dev_info["smi"])
    if want("times") or want("bitmap_times"):
        bitmap_times(bitmap_inputs(dev), dev_info["smi"])
    phase_done("times")
    launches = dict(trainer["launches"]) if trainer else {}
    if served:
        launches.update({k: served[a]["launches"][k]
                         for a, k in SERVE_KERNEL.items()})
    # each main path's launches, counted from 0 around its run
    by_path = {"trainer": trainer, "buckets": bucketed, "mamba2_train": mamba,
               "compress": compressed}
    if schemes:
        by_path.update({f"trainer --sync {k}": v
                        for k, v in schemes["trainers"].items() if k != "zen"})
    if hier:
        by_path.update({f"trainer {k}": v for k, v in hier.items()})
    if zoo:
        by_path.update({f"zoo trainer {a}": v["trainer"]
                        for a, v in zoo.items()})
    if hybrid_moe:
        by_path.update({f"trainer {a}": v["trainer"]["kernels"]
                        for a, v in hybrid_moe["models"].items()})
    path_launches = {k: {p: r["launches"][k] for p, r in by_path.items()
                         if r and r["launches"][k]} for k in SOURCES}
    if served:
        for a, k in SERVE_KERNEL.items():
            path_launches[k][f"serve {a}"] = served[a]["launches"][k]
    for group in (zoo, hybrid_moe and hybrid_moe["models"]):
        for a, v in (group or {}).items():
            for k, n in v["launches"].items():
                if n:
                    path_launches[k][f"serve {a}"] = n
    errs = {**(kern["err"] if kern else {}), **(skern["err"] if skern else {})}
    for part in (wide, shapes, hybrid_moe):
        for k, e in (part["err"] if part else {}).items():
            errs[k] = max(errs.get(k, 0.0), e)
    # the kernels at the two-level, zoo, hybrid and MoE paths' shapes
    new_rows = [r for part in (shapes, hybrid_moe) if part
                for r in part["rows"]]
    table = []
    for row in times:
        name = row["name"]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name),
            "launches_by_path": path_launches[name],
            "max_abs_err": errs[name],
            "ms": row["ms"], "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            **({"bound_split_ms": row["bound_split_ms"]}
               if "bound_split_ms" in row else {}),
            # the same kernel at the compressed path's widest shapes
            **({"wide": [{k: r[k] for k in (
                "row", "name", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by")} for r in wide["rows"] if r["kernel"] == name]}
               if wide and any(r["kernel"] == name for r in wide["rows"])
               else {}),
            # the same kernel at the two-level, zoo, hybrid and MoE paths'
            # shapes
            **({"new_shapes": [{k: r[k] for k in (
                "row", "name", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
                for r in new_rows if r["kernel"] == name]}
               if any(r["kernel"] == name for r in new_rows) else {}),
            # row 8b: the scatter-add as the baseline schemes' aggregation
            **({"agsparse_reduce": {k: schemes["row_8b"][k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}}
               if schemes and name == "coo_scatter_add" else {})})
    log(f"[done] {time.time() - t_start:.1f}s | {dev_info['smi']}")
    print(json.dumps({"kernels": table}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    main()
