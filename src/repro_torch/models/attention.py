"""GQA self-attention with QKV bias and a causal mask (port of
``repro.models.attention.gqa_train`` over ``layers.flash_attention``).

Plain PyTorch: scores by matmul in f32, the causal mask, an f32 softmax
and the weighted sum, cast back to the activations' dtype.  The reference
takes the same softmax chunk by chunk (online softmax); the results agree
to f32 rounding.  A hand-written attention kernel (the port of the
reference's ``kernels/flash.py::flash_fwd``) is its own slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import NEG, Linear, rope


class GQA(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, H, hd, kv = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_kv
        kw = dict(dtype=cfg.dtype, device=device, gen=gen)
        self.q = Linear(d, H * hd, bias=cfg.qkv_bias, **kw)
        self.k = Linear(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Linear(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.o = Linear(H * hd, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv
        g = H // KV
        pos = torch.arange(S, device=x.device)
        q = rope(self.q(x).view(B, S, H, hd), pos, cfg.rope_theta)
        k = rope(self.k(x).view(B, S, KV, hd), pos, cfg.rope_theta)
        v = self.v(x).view(B, S, KV, hd)
        qf = (q.float() * (1.0 / math.sqrt(hd))).view(B, S, KV, g, hd)
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.float())
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = torch.where(causal, s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
        return self.o(o.reshape(B, S, H * hd).to(x.dtype))
