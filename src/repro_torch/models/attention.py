"""GQA attention with QKV bias and RoPE, the encoder's and the
cross-attention's variants, and MLA, multi-head latent attention (port of
``repro.models.attention``: ``gqa_train``, ``gqa_make_cache``,
``gqa_prefill_cache``, ``gqa_decode``, ``gqa_make_cross_cache``,
``gqa_cross_decode``, ``init_mla``, ``_mla_qkv``, ``mla_train``,
``mla_make_cache`` and ``mla_decode``).

:meth:`GQA.forward` is the trainer's (and the encoder's): its attention is
``layers.flash_attention``, under autograd ``ops.FlashAttn`` -- the
``flash_fwd`` kernel's forward with the rows' log-sum-exp, and the plain
blockwise backward ``ref.flash_bwd_ref`` (the reference differentiates its
chunked online softmax by autodiff and has no backward kernel), so no S x S
score tensor is kept.  :meth:`GQA.prefill` and :meth:`GQA.cross_decode`
(serving, no gradient) run the same function on ``flash_fwd`` and keep
the decode cache.

The encoder's self-attention is ``causal=False, use_rope=False``; the
decoder's cross-attention takes K/V from ``kv_src`` (the encoder output:
no RoPE, no mask).  dtypes: whisper's frames are f32, so its encoder runs
in f32 activations on the model's weights, as JAX's promotion runs the
reference's, and the cross K/V come out in f32 while q is in the model's
dtype.  The trainer's ``FlashAttn`` takes them so, as the reference does,
promoting q to f32 (the f32 kernel) and casting the output back.
``flash_fwd`` takes q, k and v in one dtype, so serving casts the
cross K/V to q's dtype (the model's) once, when it makes the cross cache
(:meth:`GQA.make_cross_cache`), and the prefill's cross-attention and
every decode step attend to that cache.  In f32 this is the reference's
arithmetic; in bf16 it rounds the cross K/V once where the reference
keeps them in f32 (``tests/test_torch_whisper.py`` holds the bf16 model
to the reference at a stated tolerance).

:class:`MLA` (minicpm3) splits its work the same way.  q comes from a
rank-``mla_q_rank`` latent (``q_down``, ``q_norm``, ``q_up``) as
``hd`` "nope" columns and ``mla_rope_dim`` RoPE columns a head; K/V from
a rank-``mla_kv_rank`` latent ``c`` (``kv_down``, ``kv_norm``) and one
shared RoPE key ``kr`` a position (the last ``mla_rope_dim`` columns of
``kv_down``), ``kv_up`` giving each head's nope key and its value of
``mla_v_dim``.  So q/k are ``hd + mla_rope_dim`` wide (96 for minicpm3)
and v ``mla_v_dim`` (64), and the softmax scale is that of q/k's width.
The trainer's attention and the prefill's are ``flash_fwd`` at that
(96, 64) pair; the decode cache is the latent one (``c``, ``kr`` and
``pos``: no per-head K/V), and decode attends to it with ``kv_up``
absorbed into q and the output (the reference's f32 einsums, no kernel).

Tensor parallelism: with ``ctx.shard_heads`` GQA's q is column-parallel
(this rank's ``Hl = H / tp`` heads) and o row-parallel; the K/V
projections stay replicated, and each rank attends with the KV heads its
q heads use (:meth:`GQA._kv_slice`: at qwen2-0.5b's 14 / 2 heads and tp =
2, 7 q heads and 1 KV head a rank).  Otherwise every rank computes every
head.  ``ctx.h_pad`` pads the q heads to a multiple of tp with zero q
columns and zero o rows.  The cross-attention's K/V come from the
replicated ``k`` / ``v`` and the cross cache holds every KV head on every
rank; each rank slices it to its heads.  MLA's down projections and
norms are replicated, ``q_up`` and ``kv_up`` column-parallel (this
rank's heads) and o row-parallel; its latent cache holds c and kr,
which every head shares.  Decode's cache (GQA's K/V, MLA's latent) is
sequence-sharded: rank r holds positions r, r + tp, ... (prefill keeps
those of the prompt, decode writes position t on rank t % tp).  A decode
step all-gathers the token's q heads (MLA's absorbed q), so that every
rank attends with EVERY head over its own positions and the ranks'
partial softmaxes combine head by head; each rank then keeps its own
heads' output for o.  (The reference's ``gqa_decode`` and
``mla_decode`` combine the partials of different heads when the q heads
are sharded, ROADMAP queue 3.)
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import ArchConfig, ShardCtx
from repro_torch.models.layers import (NEG, Linear, RMSNorm, cache_write,
                                       decode_attention, flash_attention,
                                       rope)


def local_slots(seq: int, ctx: ShardCtx) -> int:
    """Decode-cache slots a rank holds for ``seq`` positions: ``ceil(seq /
    tp)`` (at least 1)."""
    return max(1, -(-seq // ctx.tp))


def gqa_make_cache(cfg: ArchConfig, batch: int, seq: int, *,
                   device=None, ctx: ShardCtx = ShardCtx()) -> dict:
    """One layer's empty decode cache, this rank's ``Sl =``
    :func:`local_slots` slots: k/v [batch, Sl, KV, hd] zeros in the
    model's dtype, pos [Sl] = -1 (never written)."""
    sl = local_slots(seq, ctx)
    shape = (batch, sl, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.full((sl,), -1, dtype=torch.int32, device=device)}


def prefill_slots(kv: dict, ctx: ShardCtx) -> dict:
    """This rank's round-robin share of a prompt's cache entries ({name:
    [B, S, ...]} and ``pos`` [S]): positions r, r + tp, ... in slots 0, 1,
    ...; a slot past the prompt holds zeros and position -1 (the
    reference's ``gqa_prefill_cache``)."""
    if ctx.tp == 1:
        return kv
    S = kv["pos"].shape[0]
    slots = (torch.arange(local_slots(S, ctx), device=kv["pos"].device)
             * ctx.tp + ctx.tp_rank())
    ok = slots < S
    safe = slots.clamp(max=S - 1)
    out = {}
    for name, val in kv.items():
        if name == "pos":
            out[name] = torch.where(ok, slots, -1).to(val.dtype)
        else:
            keep = ok.view(1, -1, *([1] * (val.ndim - 2)))
            out[name] = torch.where(keep, val[:, safe], 0).to(val.dtype)
    return out


class GQA(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        # the decode cache's sharding: over the model axis, or whole on
        # every rank (``decode_seq_shard`` off: no collective in decode
        # attention)
        self.cache_ctx = ctx if ctx.decode_seq_shard else ShardCtx()
        d, hd, kv = cfg.d_model, cfg.hd, cfg.n_kv
        H = ctx.h_pad or cfg.n_heads
        self.shard = ctx.shard_heads and ctx.tp > 1
        self.heads = H // ctx.tp if self.shard else H
        kw = dict(dtype=cfg.dtype, device=device, gen=gen, ctx=ctx)
        self.q = Linear(d, H * hd, bias=cfg.qkv_bias,
                        mode="col" if self.shard else "rep", **kw)
        self.k = Linear(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Linear(d, kv * hd, bias=cfg.qkv_bias, **kw)
        self.o = Linear(H * hd, d, mode="row" if self.shard else "rep", **kw)
        if ctx.h_pad:   # padded heads: zero q columns, zero o rows
            with torch.no_grad():
                real = cfg.n_heads * hd - ctx.tp_rank() * self.heads * hd
                self.q.w[:, max(real, 0):] = 0
                if self.q.b is not None:
                    self.q.b[max(real, 0):] = 0
                self.o.w[max(real, 0):] = 0

    def _kv_slice(self, k: torch.Tensor, v: torch.Tensor):
        """The KV heads (dim 2) this rank's q heads attend with: local q
        heads ``[r Hl, (r + 1) Hl)`` use KV heads from ``r Hl // g`` on
        (g = H / KV), ``Hl / g`` of them or 1 when ``g`` is a multiple of
        ``Hl`` (the reference's ``_kv_slice``).  The projections are
        replicated and each rank uses a part, so their gradients are
        summed over the model group (``copy_tp``)."""
        if not self.shard:
            return k, v
        H = self.ctx.h_pad or self.cfg.n_heads
        Hl, g = self.heads, H // self.cfg.n_kv
        count = Hl // g if Hl >= g else 1
        start = self.ctx.tp_rank() * Hl // g
        return tuple(self.ctx.copy_tp(t)[:, :, start:start + count]
                     for t in (k, v))

    def _qkv(self, x: torch.Tensor, pos: torch.Tensor | None,
             kv_src: torch.Tensor | None = None):
        """q [B, S, Hl, hd] (this rank's heads) from x and k, v [B, Sk,
        KV, hd] (every KV head) from ``kv_src`` (default x), RoPE on q and
        k at ``pos`` [S] unless ``pos`` is None."""
        cfg = self.cfg
        src = x if kv_src is None else kv_src
        B, S, _ = x.shape
        Sk = src.shape[1]
        hd, KV = cfg.hd, cfg.n_kv
        q = self.q(self.ctx.copy_tp(x) if self.shard else x).view(
            B, S, self.heads, hd)
        k = self.k(src).view(B, Sk, KV, hd)
        if pos is not None:
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        return q, k, self.v(src).view(B, Sk, KV, hd)

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                use_rope: bool = True, kv_src: torch.Tensor | None = None,
                backend: str = "cuda") -> torch.Tensor:
        """The trainer's attention over x [B, S, d] (and the encoder's, which
        keeps no cache); with ``kv_src`` [B, Sk, d] the cross-attention (no
        RoPE, no mask): ``layers.flash_attention`` on the ``backend``
        route (``ops.FlashAttn`` under autograd)."""
        B, S, _ = x.shape
        rot = use_rope and kv_src is None
        q, k, v = self._qkv(x, torch.arange(S, device=x.device) if rot
                            else None, kv_src)
        k, v = self._kv_slice(k, v)
        o = flash_attention(q, k.contiguous(), v.contiguous(),
                            causal=causal and kv_src is None, backend=backend)
        return self.o(o.reshape(B, S, -1))

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda",
                causal: bool = True, use_rope: bool = True,
                kv_src: torch.Tensor | None = None):
        """Attention over a whole prompt x [B, S, d] on ``flash_fwd`` ->
        (out [B, S, d], cache).  Self-attention (causal, RoPE at 0..S-1)
        returns this layer's decode cache for the S prompt positions: k/v
        [B, S, KV, hd] after RoPE, pos = 0..S-1; the encoder's
        (``causal=False, use_rope=False``) the same without RoPE; with
        ``kv_src`` the cross cache (:meth:`make_cross_cache`), which the
        prompt attends to without a mask.  Under tensor parallelism the
        self-attention's cache is this rank's round-robin share
        (:func:`prefill_slots`)."""
        B, S, _ = x.shape
        if kv_src is not None:
            cache = self.make_cross_cache(kv_src)
            return self._cross(x, cache, backend), cache
        pos = torch.arange(S, device=x.device)
        q, k, v = self._qkv(x, pos if use_rope else None)
        ku, vu = self._kv_slice(k, v)
        o = flash_attention(q, ku.contiguous(), vu.contiguous(),
                            causal=causal, backend=backend)
        cache = prefill_slots({"k": k, "v": v, "pos": pos.to(torch.int32)},
                              self.cache_ctx)
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
        B, ctx = x.shape[0], self.ctx
        pos = torch.full((1,), t, device=x.device)
        q, k, v = self._qkv(x[:, None], pos)
        cache_write(cache["k"], cache["v"], cache["pos"], k[:, 0], v[:, 0], t,
                    self.cache_ctx)
        q = q[:, 0]
        if self.shard:   # every head, [B, H, hd], on every rank
            q = ctx.all_gather_tp(q.transpose(0, 1)).transpose(0, 1)
        o = decode_attention(q, cache["k"], cache["v"], cache["pos"], t,
                             window=window, ctx=self.cache_ctx)
        if self.shard:
            o = o[:, ctx.tp_rank() * self.heads:][:, :self.heads]
        return self.o(o.reshape(B, -1))

    def _cross(self, x: torch.Tensor, cross: dict,
               backend: str) -> torch.Tensor:
        """x [B, S, d] attending to the cross cache (k/v [B, T, KV, hd],
        every KV head) with no mask on ``flash_fwd``: this rank's q heads
        with the KV heads they use (:meth:`_kv_slice`).  Returns [B, S,
        d]."""
        B, S, _ = x.shape
        q = self.q(x).view(B, S, self.heads, self.cfg.hd)
        k, v = self._kv_slice(cross["k"], cross["v"])
        o = flash_attention(q, k.contiguous(), v.contiguous(), causal=False,
                            backend=backend)
        return self.o(o.reshape(B, S, -1))

    def cross_decode(self, x: torch.Tensor, cross: dict, *,
                     backend: str = "cuda") -> torch.Tensor:
        """One token x [B, d] attending to the cross cache with no mask:
        one ``flash_fwd`` at Sq = 1.  Returns [B, d]."""
        return self._cross(x[:, None], cross, backend)[:, 0]


def mla_make_cache(cfg: ArchConfig, batch: int, seq: int, *,
                   device=None, ctx: ShardCtx = ShardCtx()) -> dict:
    """One MLA layer's empty latent cache, this rank's ``Sl =``
    :func:`local_slots` slots: c [batch, Sl, mla_kv_rank] and kr [batch,
    Sl, mla_rope_dim] zeros in the model's dtype, pos [Sl] = -1 (never
    written)."""
    sl = local_slots(seq, ctx)
    kw = dict(dtype=cfg.dtype, device=device)
    return {"c": torch.zeros((batch, sl, cfg.mla_kv_rank), **kw),
            "kr": torch.zeros((batch, sl, cfg.mla_rope_dim), **kw),
            "pos": torch.full((sl,), -1, dtype=torch.int32, device=device)}


class MLA(nn.Module):
    """Multi-head latent attention (minicpm3): see the module docstring."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        self.cache_ctx = ctx if ctx.decode_seq_shard else ShardCtx()
        d, H = cfg.d_model, ctx.h_pad or cfg.n_heads
        hd, rd, vd = cfg.hd, cfg.mla_rope_dim, cfg.mla_v_dim
        qr, kvr = cfg.mla_q_rank, cfg.mla_kv_rank
        self.shard = ctx.shard_heads and ctx.tp > 1
        self.heads = H // ctx.tp if self.shard else H
        up, o = ("col", "row") if self.shard else ("rep", "rep")
        kw = dict(dtype=cfg.dtype, device=device, gen=gen, ctx=ctx)
        self.q_down = Linear(d, qr, **kw)
        self.q_up = Linear(qr, H * (hd + rd), mode=up, **kw)
        self.kv_down = Linear(d, kvr + rd, **kw)
        self.kv_up = Linear(kvr, H * (hd + vd), mode=up, **kw)
        self.o = Linear(H * vd, d, mode=o, **kw)
        self.q_norm = RMSNorm(qr, device=device)
        self.kv_norm = RMSNorm(kvr, device=device)
        if ctx.h_pad:   # padded heads: zero up columns, zero o rows
            first = ctx.tp_rank() * self.heads
            with torch.no_grad():
                for lin, w in ((self.q_up, hd + rd), (self.kv_up, hd + vd),
                               (self.o, vd)):
                    real = max((cfg.n_heads - first) * w, 0)
                    if lin is self.o:
                        lin.w[real:] = 0
                    else:
                        lin.w[:, real:] = 0

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering this rank's heads (``copy_tp``
        when the heads are sharded)."""
        return self.ctx.copy_tp(t) if self.shard else t

    def _qkv(self, x: torch.Tensor, pos: torch.Tensor):
        """(q [B, S, Hl, hd + rd] of this rank's heads with RoPE on its last
        rd columns, the latent c [B, S, kvr], the shared RoPE key kr [B, S,
        rd]) of x [B, S, d] at positions ``pos`` [S] (the reference's
        ``_mla_qkv``).  The down projections and their norms are
        replicated; q's latent enters ``q_up`` through ``copy_tp``."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd, kvr = cfg.hd, cfg.mla_kv_rank
        q = self.q_up(self._copy(self.q_norm(self.q_down(x)))).view(
            B, S, self.heads, hd + cfg.mla_rope_dim)
        kv_c = self.kv_down(x)
        c = self.kv_norm(kv_c[..., :kvr])
        kr = rope(kv_c[:, :, None, kvr:], pos, cfg.rope_theta)[:, :, 0]
        q = torch.cat([q[..., :hd], rope(q[..., hd:], pos, cfg.rope_theta)],
                      dim=-1)
        return q, c, kr

    def _kv(self, c: torch.Tensor, kr: torch.Tensor):
        """Per-head k [B, S, Hl, hd + rd] (each of this rank's heads' nope
        key, then the shared RoPE key) and v [B, S, Hl, vd] from the
        latent, contiguous; c and kr enter this rank's heads through
        ``copy_tp``."""
        cfg = self.cfg
        B, S, _ = c.shape
        H, hd = self.heads, cfg.hd
        kv = self.kv_up(self._copy(c)).view(B, S, H, hd + cfg.mla_v_dim)
        k = torch.cat([kv[..., :hd], self._copy(kr)[:, :, None, :].expand(
            B, S, H, cfg.mla_rope_dim)], dim=-1)
        return k, kv[..., hd:].contiguous()

    def forward(self, x: torch.Tensor, *,
                backend: str = "cuda") -> torch.Tensor:
        """The trainer's causal attention over x [B, S, d]
        (``layers.flash_attention`` at (hd + rd, vd) on the ``backend``
        route, ``ops.FlashAttn`` under autograd; the reference's
        ``mla_train``)."""
        B, S, _ = x.shape
        q, c, kr = self._qkv(x, torch.arange(S, device=x.device))
        k, v = self._kv(c, kr)
        o = flash_attention(q, k, v, causal=True, backend=backend)
        return self.o(o.reshape(B, S, -1))

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        """Causal attention over a prompt x [B, S, d] on ``flash_fwd`` at
        (hd + rd, vd) -> (out [B, S, d], this layer's latent cache: c and
        kr of the S prompt positions, pos = 0..S-1; under tensor
        parallelism this rank's round-robin share, :func:`prefill_slots`)."""
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)
        q, c, kr = self._qkv(x, pos)
        k, v = self._kv(c, kr)
        o = flash_attention(q, k, v, causal=True, backend=backend)
        cache = prefill_slots({"c": c, "kr": kr, "pos": pos.to(torch.int32)},
                              self.cache_ctx)
        return self.o(o.reshape(B, S, -1)), cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0) -> torch.Tensor:
        """One token x [B, d] at position ``t`` (the reference's
        ``mla_decode``): its latent and RoPE key go into ``cache`` (IN
        PLACE, on the rank that owns position t), then q's nope part,
        through ``kv_up``'s key half, scores against the latent and its
        RoPE part against kr, in f32 at scale 1/sqrt(hd + rd); the
        softmax-weighted latent goes through ``kv_up``'s value half.  With
        the heads and the cache sharded, the step's absorbed q of every
        head is all-gathered, each rank scores every head over its own
        positions, the partial softmaxes combine head by head over the
        model group, and each rank keeps its own heads for ``kv_up``'s
        value half and o.  Returns [B, d]."""
        cfg, ctx, cctx = self.cfg, self.ctx, self.cache_ctx
        B, Hl = x.shape[0], self.heads
        hd, kvr = cfg.hd, cfg.mla_kv_rank
        q, c_new, kr_new = self._qkv(x[:, None],
                                     torch.full((1,), t, device=x.device))
        q = q[:, 0]
        w_up = self.kv_up.w.view(kvr, Hl, hd + cfg.mla_v_dim).float()
        q_lat = torch.einsum("bhd,khd->bhk", q[..., :hd].float(),
                             w_up[..., :hd])                  # [B, Hl, kvr]
        q_rope = q[..., hd:].float()
        gather = self.shard and cctx.tp > 1
        if gather:   # every head, [B, H, .], on every rank
            q_lat, q_rope = (ctx.all_gather_tp(a.transpose(0, 1)
                                               ).transpose(0, 1)
                             for a in (q_lat, q_rope))
        cache_write(cache["c"][:, :, None], cache["kr"][:, :, None],
                    cache["pos"], c_new, kr_new, t, cctx)
        cc, krc, pos = cache["c"].float(), cache["kr"].float(), cache["pos"]
        s = (torch.einsum("bhk,bsk->bhs", q_lat, cc)
             + torch.einsum("bhr,bsr->bhs", q_rope, krc)) \
            * (1.0 / math.sqrt(hd + cfg.mla_rope_dim))
        valid = (pos >= 0) & (pos <= t)
        if window > 0:
            valid &= pos > t - window
        s = torch.where(valid, s, NEG)
        p = torch.where(valid, torch.exp(
            s - cctx.pmax_tp(s.max(-1, keepdim=True).values)), 0.0)
        lat = cctx.psum_tp(torch.einsum("bhs,bsk->bhk", p, cc)) \
            / cctx.psum_tp(p.sum(-1)).clamp(min=1e-30)[..., None]
        if gather:
            lat = lat[:, ctx.tp_rank() * Hl:][:, :Hl]
        out = torch.einsum("bhk,khv->bhv", lat, w_up[..., hd:]).to(x.dtype)
        return self.o(out.reshape(B, -1))
