"""Batched serving example of the PyTorch port: prefill a batch of
prompts, then greedy decode from the prefill's cache (the port of
``examples/serve_batched.py``).

The reduced config of ``--arch`` (``--layers`` cuts its depth further)
with random weights from seed 0 and ``SyntheticLM`` prompts from seed 0,
as ``repro_torch.launch.serve --reduced`` serves them: the first new token
is the argmax of prefill's last-position logits, and each decode step
feeds the last token (``launch.serve.handoff`` carries the prefill cache
over; the reference example replays the prompt through decode instead).

Run: PYTHONPATH=src python examples/torch_serve_batched.py [--arch mamba2-370m]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.serve import handoff
from repro_torch.train.build import attach_serve, build_program
from repro_torch.train.steps import MODEL_INPUTS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of the reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers, n_enc_layers=min(
            cfg.n_enc_layers, args.layers))
    prog = build_program(cfg, "1x1", device=args.device)
    dev = prog.device

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- prefill -------------------------------------------------------------
    B, S = args.batch, args.prompt_len
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    b = next(iter(SyntheticLM(cfg, DataConfig(seq_len=S, batch=B))))
    prompt = {"tokens": torch.as_tensor(b["tokens"], device=dev).long(),
              **{k: torch.as_tensor(b[k], device=dev)
                 for k in MODEL_INPUTS if k in b}}
    sync()
    t0 = time.time()
    logits, cache = prog.prefill_step(prompt)
    sync()
    print(f"prefill: batch={B} len={S} {(time.time() - t0) * 1e3:.0f}ms")

    # --- decode, from the prefill's cache ------------------------------------
    attach_serve(prog, seq_len=S + args.gen, global_batch=B, mode="decode")
    tok = prog.model.gather_vocab(logits).float().argmax(-1)[:, None]
    out, lmax = [tok], []
    t0 = time.time()
    cache = handoff(prog, cache)
    for _ in range(args.gen - 1):
        tok, m, cache = prog.decode_step(cache, tok)
        out.append(tok)
        lmax.append(m)
    sync()
    dt = time.time() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    print(f"decode: generated {args.gen} tokens x {B} seqs in {dt:.2f}s "
          f"({B * (args.gen - 1) / max(dt, 1e-9):,.0f} tok/s)")
    print("sample token ids:", gen[0][:16])
    lmax = torch.stack(lmax).float().cpu().numpy() if lmax else np.zeros(0)
    assert np.isfinite(lmax).all()
    return {"prompt": b["tokens"], "tokens": gen, "logit_max": lmax}


if __name__ == "__main__":
    main()
