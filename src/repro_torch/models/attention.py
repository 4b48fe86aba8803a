"""GQA attention with QKV bias and RoPE, and the encoder's and the
cross-attention's variants (port of ``repro.models.attention``:
``gqa_train``, ``gqa_make_cache``, ``gqa_prefill_cache``, ``gqa_decode``,
``gqa_make_cross_cache`` and ``gqa_cross_decode``).

:meth:`GQA.forward` is the trainer's: plain PyTorch with autograd --
scores by matmul in f32, the causal mask (when ``causal``), an f32 softmax
and the weighted sum, cast back to the activations' dtype.  The reference
takes the same softmax chunk by chunk (online softmax); the results agree
to f32 rounding.  It does not call the ``flash_fwd`` kernel: that kernel,
like its Pallas original, is forward-only, and the reference trainer never
calls the Pallas kernel either.  :meth:`GQA.prefill` and
:meth:`GQA.cross_decode` (serving, no gradient) do: their attention is
``layers.flash_attention``.

The encoder's self-attention is ``causal=False, use_rope=False``; the
decoder's cross-attention takes K/V from ``kv_src`` (the encoder output:
no RoPE, no mask).  dtypes: whisper's frames are f32, so its encoder runs
in f32 activations on the model's weights, as JAX's promotion runs the
reference's, and the cross K/V come out in f32 while q is in the model's
dtype.  The trainer's plain attention takes them so, as the reference
does.  ``flash_fwd`` takes q, k and v in one dtype, so serving casts the
cross K/V to q's dtype (the model's) once, when it makes the cross cache
(:meth:`GQA.make_cross_cache`), and the prefill's cross-attention and
every decode step attend to that cache.  In f32 this is the reference's
arithmetic; in bf16 it rounds the cross K/V once where the reference
keeps them in f32 (``tests/test_torch_whisper.py`` holds the bf16 model
to the reference at a stated tolerance).
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

    def _qkv(self, x: torch.Tensor, pos: torch.Tensor | None,
             kv_src: torch.Tensor | None = None):
        """q [B, S, H, hd] from x and k, v [B, Sk, KV, hd] from ``kv_src``
        (default x), RoPE on q and k at ``pos`` [S] unless ``pos`` is
        None."""
        cfg = self.cfg
        src = x if kv_src is None else kv_src
        B, S, _ = x.shape
        Sk = src.shape[1]
        H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv
        q = self.q(x).view(B, S, H, hd)
        k = self.k(src).view(B, Sk, KV, hd)
        if pos is not None:
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        return q, k, self.v(src).view(B, Sk, KV, hd)

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                use_rope: bool = True,
                kv_src: torch.Tensor | None = None) -> torch.Tensor:
        """The trainer's attention over x [B, S, d]; with ``kv_src`` [B, Sk,
        d] the cross-attention (no RoPE, no mask)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv
        g = H // KV
        rot = use_rope and kv_src is None
        q, k, v = self._qkv(x, torch.arange(S, device=x.device) if rot
                            else None, kv_src)
        qf = (q.float() * (1.0 / math.sqrt(hd))).view(B, S, KV, g, hd)
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.float())
        if causal and kv_src is None:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
            s = torch.where(mask, s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
        return self.o(o.reshape(B, S, H * hd).to(x.dtype))

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda",
                causal: bool = True, use_rope: bool = True,
                kv_src: torch.Tensor | None = None):
        """Attention over a whole prompt x [B, S, d] on ``flash_fwd`` ->
        (out [B, S, d], cache).  Self-attention (causal, RoPE at 0..S-1)
        returns this layer's decode cache for the S prompt positions: k/v
        [B, S, KV, hd] after RoPE, pos = 0..S-1; the encoder's
        (``causal=False, use_rope=False``) the same without RoPE; with
        ``kv_src`` the cross cache (:meth:`make_cross_cache`), which the
        prompt attends to without a mask."""
        B, S, _ = x.shape
        if kv_src is not None:
            cache = self.make_cross_cache(kv_src)
            q = self.q(x).view(B, S, self.cfg.n_heads, self.cfg.hd)
            o = flash_attention(q, cache["k"], cache["v"], causal=False,
                                backend=backend)
            return self.o(o.reshape(B, S, -1)), cache
        pos = torch.arange(S, device=x.device)
        q, k, v = self._qkv(x, pos if use_rope else None)
        o = flash_attention(q, k, v, causal=causal, backend=backend)
        cache = {"k": k, "v": v, "pos": pos.to(torch.int32)}
        return self.o(o.reshape(B, S, -1)), cache

    def make_cross_cache(self, enc_out: torch.Tensor) -> dict:
        """The cross-attention's K/V from the encoder output [B, T, d]: k/v
        [B, T, KV, hd] in the model's dtype (contiguous, as ``flash_fwd``
        takes them)."""
        B, T, _ = enc_out.shape
        shape = (B, T, self.cfg.n_kv, self.cfg.hd)
        return {n: getattr(self, n)(enc_out).view(shape).to(
            self.cfg.dtype).contiguous() for n in ("k", "v")}

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

    def cross_decode(self, x: torch.Tensor, cross: dict, *,
                     backend: str = "cuda") -> torch.Tensor:
        """One token x [B, d] attending to the cross cache (k/v [B, T, KV,
        hd]) with no mask: one ``flash_fwd`` at Sq = 1.  Returns [B, d]."""
        B = x.shape[0]
        q = self.q(x).view(B, 1, self.cfg.n_heads, self.cfg.hd)
        o = flash_attention(q, cross["k"], cross["v"], causal=False,
                            backend=backend)
        return self.o(o.reshape(B, -1))
