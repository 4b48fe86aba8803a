"""GQA self-attention with QKV bias and RoPE (port of
``repro.models.attention``: ``gqa_train``, ``gqa_make_cache``,
``gqa_prefill_cache`` and ``gqa_decode``).

:meth:`GQA.forward` is the trainer's: plain PyTorch with autograd --
scores by matmul in f32, the causal mask, an f32 softmax and the weighted
sum, cast back to the activations' dtype.  The reference takes the same
softmax chunk by chunk (online softmax); the results agree to f32
rounding.  It does not call the ``flash_fwd`` kernel: that kernel, like
its Pallas original, is forward-only, and the reference trainer never
calls the Pallas kernel either.  :meth:`GQA.prefill` (serving, no
gradient) does: its attention is ``layers.flash_attention``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (NEG, Linear, cache_write,
                                       decode_attention, flash_attention,
                                       rope)


def gqa_make_cache(cfg: ArchConfig, batch: int, seq: int, *,
                   device=None) -> dict:
    """One layer's empty decode cache: k/v [batch, seq, KV, hd] zeros in
    the model's dtype, pos [seq] = -1 (never written)."""
    shape = (batch, seq, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.full((seq,), -1, dtype=torch.int32, device=device)}


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

    def _qkv(self, x: torch.Tensor, pos: torch.Tensor):
        """q [B, S, H, hd] and k [B, S, KV, hd] with RoPE at ``pos`` [S],
        and v [B, S, KV, hd]."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv
        q = rope(self.q(x).view(B, S, H, hd), pos, cfg.rope_theta)
        k = rope(self.k(x).view(B, S, KV, hd), pos, cfg.rope_theta)
        return q, k, self.v(x).view(B, S, KV, hd)

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        """Causal attention over a whole prompt x [B, S, d] -> (out
        [B, S, d], this layer's cache for the S prompt positions: k/v
        [B, S, KV, hd] after RoPE, pos = 0..S-1).  One ``flash_fwd``."""
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)
        q, k, v = self._qkv(x, pos)
        o = flash_attention(q, k, v, causal=True, backend=backend)
        cache = {"k": k, "v": v, "pos": pos.to(torch.int32)}
        return self.o(o.reshape(B, S, -1)), cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0) -> torch.Tensor:
        """One token x [B, d] at position ``t``: its K/V go into ``cache``
        (IN PLACE), then it attends to the cache.  Returns [B, d]."""
        B = x.shape[0]
        pos = torch.full((1,), t, device=x.device)
        q, k, v = self._qkv(x[:, None], pos)
        cache_write(cache["k"], cache["v"], cache["pos"], k[:, 0], v[:, 0], t)
        o = decode_attention(q[:, 0], cache["k"], cache["v"], cache["pos"], t,
                             window=window)
        return self.o(o.reshape(B, -1))
