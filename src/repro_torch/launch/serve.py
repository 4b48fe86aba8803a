"""Batched serving of the PyTorch port: prefill a batch of prompts, then
greedy decode (port of ``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 8 --prompt-len 512 --gen 16

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path on the CPU.
The prompts are ``SyntheticLM`` batches from ``--seed``; the weights are
random, drawn from the same seed.  Prefill runs every layer over the whole
prompt (attention on the ``flash_fwd`` kernel, the Mamba2 scan on
``ssd_fwd``; zamba2 runs both, MoE models route each layer's tokens to
their experts; ``--backend torch`` takes their plain versions) and its cache
is carried over to decode: the first new token is the argmax of prefill's
last-position logits, and each of the ``--gen - 1`` decode steps feeds the
last token and takes the next.  (The reference example instead replays the
prompt through decode and feeds its last token twice.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.train import steps as st
from repro_torch.train.build import Program, attach_serve, build_program

ARCHS = ("qwen2-0.5b", "mamba2-370m", "qwen2.5-3b", "phi4-mini-3.8b",
         "zamba2-1.2b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48,
                    help="new tokens per sequence (>= 1)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut, for a "
                         "model one card cannot hold)")
    ap.add_argument("--dtype", default=None, choices=tuple(DTYPES),
                    help="override the config's dtype")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="prefill kernels: the CUDA kernels, or their plain "
                         "PyTorch versions")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1 \
            or (args.layers is not None and args.layers < 1):
        ap.error("--gen, --prompt-len, --batch and --layers must be "
                 "positive")
    return args


@torch.inference_mode()
def handoff(prog: Program, cache: dict) -> dict:
    """The decode cache continuing a prefill ``cache``: a
    ``make_cache(B, S + gen)`` cache with ``t = S`` whose attention
    entries hold the prompt's S K/V slots and positions; a Mamba2 entry
    (SSD state and conv tail) is the decode cache already and is taken
    as it is.  The entries are in execution order (the hybrid's attention
    applications among its Mamba2 layers)."""
    dec = prog.fresh_cache()
    S = cache["t"]
    for i, (new, old) in enumerate(zip(dec["layers"], cache["layers"])):
        if "k" not in new:
            dec["layers"][i] = old
            continue
        new["k"][:, :S] = old["k"]
        new["v"][:, :S] = old["v"]
        new["pos"][:S] = old["pos"]
    dec["t"] = S
    return dec


def main(argv=None) -> dict:
    """Serve one batch; returns the prompt, the generated tokens [B, gen],
    prefill's last-position logits (f32, CPU), per-step max logits and
    top-2 gaps, prefill ms, decode tok/s (host clock after a device sync)
    and the prefill kernels' launch and plain-call counters."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=DTYPES[args.dtype])
    prog = build_program(cfg, "1x1", device=args.device, seed=args.seed,
                         backend=args.backend)
    dev = prog.device
    B, S = args.batch, args.prompt_len
    print(f"arch={cfg.name} params="
          f"{sum(p.numel() for p in prog.model.parameters()) / 1e6:.1f}M "
          f"batch={B} prompt={S} gen={args.gen} backend={args.backend} "
          f"device={dev} dtype={str(cfg.dtype).replace('torch.', '')}",
          flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    b = next(iter(SyntheticLM(cfg, DataConfig(seq_len=S, batch=B,
                                              seed=args.seed))))
    tokens = torch.as_tensor(b["tokens"], device=dev).long()
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    sync()
    t0 = time.perf_counter()
    logits, cache = prog.prefill_step({"tokens": tokens})
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    attach_serve(prog, seq_len=S + args.gen, global_batch=B, mode="decode")
    decode = st.make_decode_step(prog.model, prog.cache_specs["window"],
                                 return_gap=True)
    lf = logits.float()
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
    gen = torch.cat(out, dim=1).cpu().numpy()
    lmax_np = torch.stack(lmax).float().cpu().numpy()
    if not np.isfinite(lmax_np).all():
        raise FloatingPointError("non-finite logits while serving")
    tok_s = B * (args.gen - 1) / decode_s if args.gen > 1 else 0.0
    counts = {k: ops.LAUNCHES[k] for k in ops.MODEL_KERNELS}
    plain = {k: ops.PLAIN_CALLS[k] for k in ops.MODEL_KERNELS}
    print(f"prefill: {prefill_ms:.1f} ms | decode: {args.gen - 1} steps "
          f"{decode_s * 1e3:.1f} ms, {tok_s:,.0f} tok/s | launches {counts} "
          f"plain calls {plain}", flush=True)
    print("sample token ids:", gen[0][:16].tolist())
    return {"prompt": b["tokens"], "tokens": gen,
            "prefill_logits": lf.cpu(), "logit_max": lmax_np,
            "top2_gap": torch.stack(gaps).float().cpu().numpy(),
            "prefill_ms": prefill_ms, "decode_s": decode_s,
            "decode_tok_per_s": tok_s, "launches": counts,
            "plain_calls": plain}


if __name__ == "__main__":
    main()
