"""End-to-end driver of the PyTorch port: train a ~100M-parameter
qwen2-family model with Zen gradient synchronization, checkpoint it and
report throughput (the port of ``examples/train_e2e.py``).

It runs on one worker (mesh 1x1) on the card; ``repro_torch.launch.train``
runs bigger meshes.  ``--layers`` cuts the depth, ``--vocab`` the
vocabulary and ``--batch`` / ``--seq-len`` the batch (by default the
reference's 8 layers, 151936 tokens and 8 x 256), for a quick run on the
CPU.

Run: PYTHONPATH=src python examples/torch_train_e2e.py [--steps 200]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.io import gather_params, restore, save
from repro_torch.configs import get_config
from repro_torch.core.zen import SyncConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "zen_e2e_ckpt"))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=None,
                    help="cut the vocabulary (default: qwen2-0.5b's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    # ~100M params: qwen2-0.5b geometry, shrunk to 8 layers / d512 but with
    # the full 151936-token vocabulary, so the embedding grads are sparse
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"),
        n_layers=args.layers, d_model=512, n_heads=8, n_kv=2, head_dim=64,
        d_ff=1536)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)
    tcfg = TrainerConfig(
        opt=OptConfig(lr=3e-4, grad_clip=1.0),
        sync=SyncConfig(scheme="zen", density_budget=0.25),
        zero1=True)
    prog = build_program(cfg, "1x1", tcfg, device=args.device)
    attach_train(prog)
    dev = prog.device
    n_params = sum(p.numel() for p in prog.model.parameters())
    print(f"model: {cfg.name}-100m  params={n_params / 1e6:.1f}M  "
          f"vocab={cfg.vocab}  layers={cfg.n_layers}  device={dev}")

    seq, batch_size = args.seq_len, args.batch
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=seq, batch=batch_size)))
    t0, losses = time.time(), []
    for step in range(args.steps):
        b = next(data)
        batch = {k: torch.as_tensor(v, device=dev).long()
                 for k, v in b.items()}
        m = prog.train_step(batch)
        losses.append(float(m["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            toks = batch_size * seq * (step + 1)
            print(f"step {step:4d}  loss={losses[-1]:.4f}  "
                  f"tok/s={toks / (time.time() - t0):,.0f}  "
                  f"zen_words={float(m['sync/sparse_sent_words']):,.0f}")
    tok_s = batch_size * seq * args.steps / (time.time() - t0)

    params = gather_params(prog.model)
    save(args.ckpt, {"params": params, "step": args.steps})
    back = restore(args.ckpt, dev)
    assert back["step"] == args.steps
    same = all(torch.equal(back["params"][k].view(torch.uint8),
                           v.detach().contiguous().view(torch.uint8))
               for k, v in params.items())
    assert same and set(back["params"]) == set(params)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"checkpoint restored bitwise from {args.ckpt}")
    assert losses[-1] < losses[0]
    return {"losses": losses, "tok_per_s": tok_s, "restored_bitwise": same,
            "params": n_params}


if __name__ == "__main__":
    main()
