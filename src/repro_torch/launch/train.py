"""Training launcher of the PyTorch port (the reference's flags).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --mesh 8x1 --sync zen --global-batch 8 --seq-len 512 --steps 4

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
The D ranks of a ``Dx1`` mesh (P x D of a ``PxDx1`` one: each pod syncs
its D ranks, then the pods' results are averaged) run in one of two modes
(train/steps.py):

* without ``--dist``, all D ranks are held in this one process;
* with ``--dist {gloo,nccl}``, each process started by ``torchrun`` runs
  one rank over a ``torch.distributed`` group (launch/mesh.py), e.g.

      PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
          -m repro_torch.launch.train --arch qwen2-0.5b --mesh 4x1 \\
          --dist gloo --sync zen --global-batch 8 --seq-len 512 --steps 4

  gloo lets several ranks share one GPU (or run on the CPU with
  ``--device cpu``); nccl needs a GPU per rank.  Only rank 0 prints, and
  ``main`` returns the same dict on every rank.

``--node-size k`` (a divisor of D) makes the data-parallel world two-level:
nodes of k consecutive ranks, every bucket's plan run inside each node and
then across the nodes (``core/topology.py``; ``--sync auto`` prices the
plans on the α-β topology, whose defaults, or ``--alpha-beta``'s values,
are planning constants, not measurements).  Flags the port does not run
yet raise ``NotImplementedError`` naming the ROADMAP item that brings them.
``--no-zero1`` is accepted: the port always runs the full update, which
gives the same numbers as ZeRO-1.
``--no-fused-commit`` runs Zen's commit through the pre-fusion chain of
kernels (scatter-add, bitmap pack and unpack) instead of the push and pull
megakernels, with the same results.  ``--bucket-bytes N`` fuses
consecutive dense leaves of one dtype into psum buckets of at most N bytes
(core/buckets.py); the synced values do not change.  ``--compress
topk:0.01`` (or ``randk:D``, ``threshold:T``, ``:noef`` for no error
feedback) EF-sparsifies every dense bucket before the sync
(core/sparsify.py); ``--ckpt-dir DIR`` saves ``{"params", "step"}`` to
``DIR/final`` (and ``DIR/step_<k>`` every ``--ckpt-every`` steps) with
``checkpoint/io.py``, rank 0 writing.  ``--sync`` takes every executable
scheme of the registry (``core/registry.py``) or ``auto``, the cost
model's per-bucket choice (``core/costmodel.py``).  ``--replan-every N``
with ``--sync auto`` and ``--compress`` runs the density controller
(``core/sparsify.py``): the measured ``sync/ef_density*`` metrics of every
``--log-every`` step feed it, and at every N-th step whose measured
densities flip a bucket's choice the plan is rebuilt (``attach_train``
with the measured profiles), the optimizer state carried over; with an
explicit ``--sync`` it does nothing, as in the reference.  ``--arch
mamba2-370m`` trains the Mamba2 LM, its scan on the ``ssd_fwd`` kernel
under autograd; ``zamba2-1.2b`` the hybrid (Mamba2 layers and one shared
attention block); ``olmoe-1b-7b`` and ``phi3.5-moe-42b-a6.6b`` the MoE
decoders, whose router stats (``moe/aux_loss``, ``moe/dropped``,
``moe/skew``) are logged beside the loss.  The plan GradSync runs is
printed at start.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import save
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.registry import cli_scheme_choices
from repro_torch.core.sparsify import DensityController
from repro_torch.core.zen import SyncConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (BACKENDS, make_data_group,
                                     make_level_groups)
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM, e.g. 8x1 "
                    "or 2x4x1 (M must be 1)")
    ap.add_argument("--sync", default="zen", choices=cli_scheme_choices())
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--density-budget", type=float, default=0.25)
    ap.add_argument("--bucket-bytes", type=int, default=None)
    ap.add_argument("--node-size", type=int, default=1,
                    help="ranks per node: splits D into nodes of this many "
                         "consecutive ranks (a two-level topology); must "
                         "divide D; 1 = flat")
    ap.add_argument("--alpha-beta", default=None,
                    help="α-β link override of the topology cost model: "
                         "'a_intra,b_intra,a_inter,b_inter' (µs, µs per "
                         "f32 word) or 'a,b' for every level")
    ap.add_argument("--compress", default="none")
    ap.add_argument("--calib-file", default=None)
    ap.add_argument("--no-fused-commit", action="store_true")
    ap.add_argument("--replan-every", type=int, default=0)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="kernel route (Zen's, and the Mamba2 scan's): the "
                         "CUDA kernels, or their plain PyTorch versions")
    ap.add_argument("--dist", default=None, choices=BACKENDS,
                    help="one rank per process under torchrun, over this "
                         "torch.distributed backend (default: all ranks "
                         "in this process)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns losses, final tok/s, sparse words, overflow, step
    times (host clock after a device sync, seconds), each logged step's
    sparse words, grad norm and dense words, the steps at which the
    density controller rebuilt the plan, the plan's ``describe()`` lines
    at the end, the bucket plan (kind, dtype, bytes and leaves of each
    bucket), each logged step's words by level on a two-level topology
    (``intra_words``, ``inter_words``), an MoE model's router stats at
    each logged step (``moe``: ``{"moe/aux_loss": [...], ...}``, group
    means) and the kernels' launches and plain calls in the run, summed
    over the group."""
    args = parse_args(argv)
    if args.dist is None:
        return _train(args, None, args.device)
    group, dev = make_data_group(args.dist, args.device)
    try:
        return _train(args, group, dev)
    finally:
        dist.destroy_process_group()


def _counts() -> torch.Tensor:
    """int64 [2, kernels]: this process's launch and plain-call counters."""
    return torch.tensor([[c[k] for k in kops.KERNELS]
                         for c in (kops.LAUNCHES, kops.PLAIN_CALLS)])


def _train(args, group, device) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        opt=OptConfig(lr=args.lr),
        sync=SyncConfig(scheme=args.sync, density_budget=args.density_budget,
                        bucket_bytes=args.bucket_bytes, compress=args.compress,
                        alpha_beta=args.alpha_beta, calib_file=args.calib_file,
                        fused_commit=not args.no_fused_commit,
                        backend=args.backend, seed=args.seed))
    prog = build_program(cfg, args.mesh, tcfg, device=device,
                         seed=args.seed, backend=args.backend, group=group,
                         node_size=args.node_size)
    attach_train(prog)
    topo = prog.gradsync.topology
    make_level_groups(prog.group, topo, prog.pods)
    dev = prog.device
    log = print if prog.group.ranks[0] == 0 else _quiet   # rank 0 prints
    n_params = sum(p.numel() for p in prog.model.parameters())
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh={args.mesh} "
        f"sync={args.sync} compress={args.compress} backend={args.backend} "
        f"node_size={args.node_size} device={dev} "
        f"dtype={str(cfg.dtype).replace('torch.', '')}", flush=True)
    for line in prog.gradsync.describe():   # the plan the run executes
        log(f"  {line}")
    if not topo.flat:
        log(f"  (α-β: {'--alpha-beta' if args.alpha_beta else 'defaults'}: "
            f"planning constants of the cost model, not measurements)")

    # adaptive density control: measured post-compression densities feed
    # choose_scheme; a flip triggers a replan.  Only under 'auto': an
    # explicit scheme ignores the recommendations, so a disagreeing
    # controller would flag drift every interval without converging.
    controller = None
    if (args.replan_every and prog.gradsync.has_compression
            and args.sync == "auto"):
        controller = DensityController(
            prog.gradsync.compressed_buckets(),
            prog.gradsync.bucket_schemes(), n=prog.n_data,
            threshold=tcfg.sync.auto_threshold,
            topology=None if topo.flat else topo)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def checkpoint(name: str, step: int) -> None:
        if args.ckpt_dir and prog.group.ranks[0] == 0:   # rank 0 writes
            save(Path(args.ckpt_dir) / name,
                 {"params": dict(prog.model.named_leaves()), "step": step})

    data = iter(SyntheticLM(cfg, DataConfig(
        seq_len=args.seq_len, batch=args.global_batch, seed=args.seed)))
    losses, step_s, words, ovf, gnorm, dwords = [], [], [], [], [], []
    levels: dict[str, list[float]] = {}   # two-level topologies' words
    moe: dict[str, list[float]] = {}      # an MoE model's router stats
    replans: list[int] = []
    tokens_done = 0
    counts0 = _counts()
    sync()
    t0 = time.time()
    for step in range(args.steps):
        b = next(data)
        t_step = time.time()
        batch = {k: torch.as_tensor(v, device=dev).long()
                 for k, v in b.items()}
        m = prog.train_step(batch)
        tokens_done += args.global_batch * args.seq_len
        if step % args.log_every == 0 or step == args.steps - 1:
            sync()
            dt = time.time() - t0
            step_s.append(time.time() - t_step)
            losses.append(float(m["loss"]))
            words.append(float(m["sync/sparse_sent_words"]))
            ovf.append(int(float(m["sync/overflow"])))
            gnorm.append(float(m["grad_norm"]))
            dwords.append(float(m["sync/dense_words"]))
            for k in ("intra_words", "inter_words"):
                if f"sync/{k}" in m:
                    levels.setdefault(k, []).append(float(m[f"sync/{k}"]))
            for k in sorted(k for k in m if k.startswith("moe/")):
                moe.setdefault(k, []).append(float(m[k]))
            log(f"step {step:5d} loss={losses[-1]:.4f} "
                f"tok/s={tokens_done / dt:,.0f} "
                f"sparse_words={words[-1]:,.0f} overflow={ovf[-1]}"
                + "".join(f" {k}={v[-1]:.4f}" for k, v in moe.items()),
                flush=True)
        if controller is not None and step % args.log_every == 0:
            controller.observe({k: float(v) for k, v in m.items()
                                if k.startswith("sync/ef_density")})
        if (controller is not None and step
                and step % args.replan_every == 0):
            drift = controller.drifted()
            if drift:
                log(f"replan @ step {step}: density drift flips "
                    f"{drift} — rebuilding plan", flush=True)
                attach_train(prog, sparsity_profiles=controller.profiles())
                controller.rebase(prog.gradsync.bucket_schemes())
                replans.append(step)
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            checkpoint(f"step_{step}", step)
    checkpoint("final", args.steps)
    sync()
    dt = time.time() - t0
    log("done")
    counts = (_counts() - counts0)[None].to(dev)   # [1 process, 2, kernels]
    if group is not None:
        # every rank returns rank 0's clock
        clock = torch.tensor([[dt, *step_s]], dtype=torch.float64, device=dev)
        dt, *step_s = group.all_gather(clock)[0].tolist()
        counts = group.all_gather(counts)            # [ranks, 2, kernels]
    total = counts.sum(0).tolist()
    out = {"losses": losses, "tok_per_s": tokens_done / dt,
           "sparse_words": words[-1] if words else 0.0,
           "overflow": max(ovf) if ovf else 0, "step_s": step_s,
           "median_step_s": float(np.median(step_s)) if step_s else 0.0,
           "sparse_words_by_step": words, "grad_norm": gnorm,
           "dense_words": dwords, "replans": replans, **levels,
           **({"moe": moe} if moe else {}),
           "plan": prog.gradsync.describe(),
           "buckets": [{"kind": b.kind, "nbytes": b.nbytes,
                        "leaves": len(b.slots),
                        "dtype": str(b.slots[0].dtype).replace("torch.", "")}
                       for b in prog.gradsync.plan.buckets],
           "launches": dict(zip(kops.KERNELS, total[0])),
           "plain_calls": dict(zip(kops.KERNELS, total[1]))}
    if group is not None:
        by_rank = {k: counts[:, 0, i].tolist()
                   for i, k in enumerate(kops.KERNELS)}
        log(f"dist result {json.dumps({**out, 'launches_by_rank': by_rank})}")
    return out


def _quiet(*_args, **_kwargs) -> None:
    """``log`` of a rank other than 0."""


if __name__ == "__main__":
    main()
