"""Batched serving of the PyTorch port: prefill a batch of prompts, then
greedy decode (port of ``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 8 --prompt-len 512 --gen 16

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
``--shape NAME`` takes one of the paper's input shapes
(``configs.INPUT_SHAPES``; ``--batch`` and ``--layers`` still cut it to
one card): a prefill shape sets the prompt to its length and the batch to
its own; a decode shape sets the batch and sizes the decode cache to its
length (a sliding window of ``sliding_window`` slots above 65,536 tokens,
as ``attach_serve`` does), and decodes from a ``--prompt-len`` prompt's
prefill.
The prompts are ``SyntheticLM`` batches from ``--seed``; the weights are
random, drawn from the same seed.  Prefill runs every layer over the whole
prompt (attention on the ``flash_fwd`` kernel, the Mamba2 scan on
``ssd_fwd``; zamba2 runs both, MoE models route each layer's tokens to
their experts; whisper encodes its batch's stub frames on ``flash_fwd``
and cross-attends to them, pixtral puts its stub patches before the
prompt, minicpm3's MLA attends on ``flash_fwd`` at q/k 96 and v 64 and
keeps the latent cache; ``--backend torch`` takes the plain versions) and
its cache is carried over to decode: the first new token is the argmax of
prefill's last-position logits, and each of the ``--gen - 1`` decode
steps feeds the last token and takes the next (whisper's cross-attention
one ``flash_fwd`` a layer a step).  (The reference example instead
replays the prompt through decode and feeds its last token twice.)

``--mesh 1xM --dist {gloo,nccl}`` under ``torchrun --nproc-per-node M``
serves every model tensor-parallel over the model group: each rank's
prefill runs ``flash_fwd`` on its own heads (the encoder's and the
cross-attention's too) and ``ssd_fwd`` on its own SSM heads, and keeps
its round-robin share of the prompt's K/V or MLA latent (positions r, r
+ M, ...) and its heads' SSD state; decode attends over the
sequence-sharded cache (whisper's cross cache whole on every rank), and
the first token is the argmax of the gathered last-position logits
(``--pad-heads`` and ``--moe-a2a`` as in ``launch/train.py``).  Only rank
0 prints.

``--mesh DxM`` or ``PxDxM`` with P x D > 1 serves data-parallel under
``torchrun --nproc-per-node P*D*M`` (M may be 1; rank ``w M + m``,
``launch/mesh.py``): data rank ``w`` (pod-major) takes the batch's
contiguous rows ``[w B / (P D), (w + 1) B / (P D))``, the reference's
``batch_pspecs`` order, and serves them over its model group as above;
the greedy tokens and the last-position logits are gathered over the
data group in the batch's order.  A batch that P x D does not divide
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BACKENDS, make_mesh_groups
from repro_torch.train import steps as st
from repro_torch.train.steps import MODEL_INPUTS
from repro_torch.train.build import (Program, attach_serve, build_program,
                                     parse_mesh)

ARCHS = ("qwen2-0.5b", "mamba2-370m", "qwen2.5-3b", "phi4-mini-3.8b",
         "zamba2-1.2b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
         "whisper-medium", "pixtral-12b", "minicpm3-4b")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (default 4, or the --shape's batch)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default 32, or a prefill "
                         "--shape's length)")
    ap.add_argument("--shape", default=None,
                    choices=[k for k, v in INPUT_SHAPES.items()
                             if v["mode"] != "train"],
                    help="one of the paper's serve input shapes")
    ap.add_argument("--gen", type=int, default=48,
                    help="new tokens per sequence (>= 1)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut, for a "
                         "model one card cannot hold; an encoder-decoder's "
                         "encoder too)")
    ap.add_argument("--dtype", default=None, choices=tuple(DTYPES),
                    help="override the config's dtype")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="prefill kernels: the CUDA kernels, or their plain "
                         "PyTorch versions")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM: P x D data-parallel ranks of M "
                         "tensor-parallel ranks each (P x D x M > 1: with "
                         "--dist)")
    ap.add_argument("--dist", default=None, choices=BACKENDS,
                    help="one rank per process under torchrun, over this "
                         "torch.distributed backend")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad the q heads to a multiple of M so that they "
                         "shard over the model axis")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="MoE: the token-sharded all-to-all dispatch over "
                         "the model axis (M > 1)")
    args = ap.parse_args(argv)
    spec = INPUT_SHAPES[args.shape] if args.shape else None
    if args.batch is None:
        args.batch = spec["global_batch"] if spec else 4
    if spec and spec["mode"] == "prefill":
        if args.prompt_len not in (None, spec["seq_len"]):
            ap.error(f"--shape {args.shape} prefills {spec['seq_len']} "
                     f"tokens; drop --prompt-len")
        args.prompt_len = spec["seq_len"]
    elif args.prompt_len is None:
        args.prompt_len = 32
    pods, dp, _ = parse_mesh(args.mesh)
    if pods * dp > 1 and args.dist is None:
        ap.error(f"--mesh {args.mesh}: a data-parallel server runs one "
                 f"process a rank: start it under torchrun with --dist")
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1 \
            or (args.layers is not None and args.layers < 1):
        ap.error("--gen, --prompt-len, --batch and --layers must be "
                 "positive")
    if spec and spec["mode"] == "decode" \
            and args.prompt_len + args.gen > spec["seq_len"]:
        ap.error(f"--shape {args.shape}: the prompt and the new tokens "
                 f"must fit its {spec['seq_len']} positions")
    return args


@torch.inference_mode()
def handoff(prog: Program, cache: dict) -> dict:
    """The decode cache continuing a prefill ``cache``: a
    ``make_cache(B, S + gen)`` cache with ``t = S`` (a VLM's S counts its
    patch prefix) whose attention entries hold the prompt's S K/V slots
    (MLA's latent c and kr) and positions, and an encoder-decoder layer's
    entry the prefill's cross cache; a Mamba2 entry (SSD state and conv
    tail) is the decode cache already and is taken as it is.  The entries
    are in execution order (the hybrid's attention applications among its
    Mamba2 layers)."""
    dec = prog.fresh_cache()
    for i, (new, old) in enumerate(zip(dec["layers"], cache["layers"])):
        if "pos" not in new:
            dec["layers"][i] = old
            continue
        n = old["pos"].shape[0]   # the prompt's slots (this rank's share)
        for key, val in old.items():
            if key == "cross":
                new[key] = val
            elif key == "pos":
                new[key][:n] = val
            else:
                new[key][:, :n] = val
    dec["t"] = cache["t"]
    return dec


def main(argv=None) -> dict:
    """Serve one batch; returns the prompt, the generated tokens [B, gen]
    and prefill's last-position logits (f32, CPU, every vocab shard), both
    of the whole batch, the rows ``(lo, hi)`` this process served, its
    per-step max logits and top-2 gaps, prefill ms, decode tok/s (host
    clock after a device sync; the slowest data rank's), the positions the first layer's decode cache holds
    at the end (``cache_pos``: this rank's share), the card's peak
    allocated GiB over the run (``peak_gib``; None on the CPU), the
    decode cache's slots (``cache_len``) and this process's
    model kernels' launch and plain-call counters (and the launches of
    the decode steps alone: whisper's cross-attention)."""
    args = parse_args(argv)
    if args.dist is None:
        return serve(args, None, None, args.device)
    pods, _, tp = parse_mesh(args.mesh)
    group, model_group, dev = make_mesh_groups(args.dist, tp, pods,
                                               device=args.device)
    try:
        return serve(args, group, model_group, dev)
    finally:
        dist.destroy_process_group()


def serve(args, group, model_group, device) -> dict:
    """``main``'s run on groups already joined: ``group`` the data group of
    the mesh's P x D ranks (None: one process serves the whole batch),
    ``model_group`` the model group (None at M = 1)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers, n_enc_layers=min(
            cfg.n_enc_layers, args.layers))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=DTYPES[args.dtype])
    ndata = 1 if group is None else group.n
    B, S = args.batch, args.prompt_len
    if B % ndata:
        raise ValueError(f"--batch {B} does not split over the mesh "
                         f"{args.mesh}'s P x D = {ndata} data ranks")
    w = 0 if group is None else group.ranks[0]
    lo, hi = w * B // ndata, (w + 1) * B // ndata   # this rank's sequences
    prog = build_program(cfg, args.mesh, device=device, seed=args.seed,
                         backend=args.backend, model_group=model_group,
                         group=group if ndata > 1 else None,
                         pad_heads=args.pad_heads,
                         moe_a2a=args.moe_a2a)
    dev = prog.device
    root = prog.model.ctx.tp_rank() == 0 and w == 0
    log = print if root else (lambda *a, **k: None)   # rank 0 prints
    log(f"arch={cfg.name} mesh={args.mesh} params="
          f"{sum(p.numel() for p in prog.model.parameters()) / 1e6:.1f}M "
          f"batch={B} prompt={S} gen={args.gen} shape={args.shape} "
          f"backend={args.backend} "
          f"device={dev} dtype={str(cfg.dtype).replace('torch.', '')}",
          flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    b = next(iter(SyntheticLM(cfg, DataConfig(seq_len=S, batch=B,
                                              seed=args.seed))))
    batch = {"tokens": torch.as_tensor(b["tokens"][lo:hi], device=dev).long(),
             **{k: torch.as_tensor(b[k][lo:hi], device=dev)
                for k in MODEL_INPUTS if k in b}}
    attach_serve(prog, seq_len=S, global_batch=hi - lo, mode="prefill")
    sync()
    t0 = time.perf_counter()
    logits, cache = prog.prefill_step(batch)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    in_prefill = {k: ops.LAUNCHES[k] for k in ops.MODEL_KERNELS}

    # a decode shape sizes the cache to its length, else the run's tokens
    attach_serve(prog, seq_len=(INPUT_SHAPES[args.shape]["seq_len"]
                                if args.shape and INPUT_SHAPES[args.shape]
                                ["mode"] == "decode" else S + args.gen),
                 global_batch=hi - lo, mode="decode")
    decode = st.make_decode_step(prog.model, prog.cache_specs["window"],
                                 return_gap=True)
    lf = prog.model.gather_vocab(logits).float()
    top = lf.topk(2, dim=-1).values
    tok = lf.argmax(-1)[:, None]
    out, lmax, gaps = [tok], [top[:, 0]], [top[:, 0] - top[:, 1]]
    sync()
    t0 = time.perf_counter()
    cache = handoff(prog, cache)
    for _ in range(args.gen - 1):
        tok, m, cache, gap = decode(cache, tok)
        out.append(tok)
        lmax.append(m)
        gaps.append(gap)
    sync()
    decode_s = time.perf_counter() - t0
    lmax_np = torch.stack(lmax).float().cpu().numpy()
    if not np.isfinite(lmax_np).all():
        raise FloatingPointError("non-finite logits while serving")
    gen, lf_all = torch.cat(out, dim=1), lf
    if ndata > 1:
        # the data ranks' sequences in the batch's order; the slowest
        # rank's clock
        gen = group.all_gather(gen[None]).flatten(0, 1)
        lf_all = group.all_gather(lf[None]).flatten(0, 1)
        clock = torch.tensor([[prefill_ms, decode_s]], dtype=torch.float64,
                             device=dev)
        prefill_ms, decode_s = group.all_gather(clock).amax(0).tolist()
    gen = gen.cpu().numpy()
    tok_s = B * (args.gen - 1) / decode_s if args.gen > 1 else 0.0
    counts = {k: ops.LAUNCHES[k] for k in ops.MODEL_KERNELS}
    plain = {k: ops.PLAIN_CALLS[k] for k in ops.MODEL_KERNELS}
    in_decode = {k: counts[k] - in_prefill[k] for k in counts}
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
    log(f"prefill: {prefill_ms:.1f} ms | decode: {args.gen - 1} steps "
        f"{decode_s * 1e3:.1f} ms, {tok_s:,.0f} tok/s | cache "
        f"{prog.cache_specs['cache_len']} slots | peak {peak_gib} GiB | "
        f"launches {counts} "
        f"(in decode {in_decode}) "
        f"plain calls {plain}", flush=True)
    log("sample token ids:", gen[0][:16].tolist())
    attn = next((c for c in cache["layers"] if "pos" in c), None)
    return {"prompt": b["tokens"], "tokens": gen, "rows": (lo, hi),
            "prefill_logits": lf_all.cpu(), "logit_max": lmax_np,
            "top2_gap": torch.stack(gaps).float().cpu().numpy(),
            "prefill_ms": prefill_ms, "decode_s": decode_s,
            "decode_tok_per_s": tok_s, "launches": counts,
            "decode_launches": in_decode, "peak_gib": peak_gib,
            "cache_len": prog.cache_specs["cache_len"],
            "cache_pos": None if attn is None else attn["pos"].cpu().numpy(),
            "plain_calls": plain}


if __name__ == "__main__":
    main()
