"""Primitive layers of the port's models (port of ``repro.models.layers``).

RMSNorm (plain and over the SSM's d_inner), RoPE, the SwiGLU and GELU
MLPs, the untied input embedding, the LM head with its cross-entropy
(:func:`lm_head_loss_chunked` in training, 512 positions at a time),
attention (:func:`flash_attention`, on the ``flash_fwd`` kernel: the
prefill's, and under autograd every trainer's through ``ops.FlashAttn``)
and decode attention over a KV cache.  Under tensor parallelism (a
``ShardCtx`` with tp > 1, ``models/common.py``) these are the reference's
Megatron-style layers: ``Linear`` in the col (output features sharded),
row (input features sharded, a ``psum_tp`` before the bias) and rep
modes, the vocab-parallel embedding and cross-entropy, decode attention
over the sequence-sharded cache (slot ``(t // tp) % Sl`` of rank ``t %
tp`` holds position t) and the SwiGLU and GELU MLPs column -> row.  A
sharded leaf is drawn whole from the generator and sliced, so every mesh
holds slices of the parameters the 1x1 build draws.  Numerics follow the reference: norms and the
softmax run in f32, matmuls in the parameters' dtype.  A linear layer
given activations of another dtype promotes as JAX does: f32 activations
on bf16 weights (whisper's f32 encoder frames) run in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.hashing import check_backend
from repro_torch.kernels import ops
from repro_torch.models.common import ShardCtx
from repro_torch.kernels.ref import NEG, flash_fwd_ref


def _normal(gen: torch.Generator | None, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """``normal(0, 1) * scale`` drawn in f32 from ``gen``, cast to dtype."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32; the scale is f32."""

    def __init__(self, d: int, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


def rmsnorm_sharded(scale: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-5, ctx: ShardCtx = ShardCtx()
                    ) -> torch.Tensor:
    """The reference's RMSNorm over a model-sharded feature dim (the
    Mamba2 gated norm over d_inner): ``sum(x^2)`` over the whole dim (a
    model psum) ``/ d`` in f32; ``scale`` and ``x`` are this rank's
    slices.  Each rank uses the variance on its own features, so its
    gradient is summed over the ranks (``copy_tp``)."""
    xf = x.float()
    full = x.shape[-1] * ctx.tp
    var = ctx.copy_tp(ctx.psum_tp((xf * xf).sum(-1, keepdim=True))) / full
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


LINEAR_DIMS = {"col": (1, 0), "row": (0, None), "rep": (None, None)}


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` stored [d_in, d_out] as in the reference;
    init ``normal * 1/sqrt(d_in)``, zero bias.  Mixed dtypes promote as
    ``jnp.matmul`` does (f32 @ bf16 runs in f32).

    ``mode`` (the reference's ``init_linear``): ``"col"`` keeps this
    rank's slice of the output features (w's and b's), ``"row"`` its
    slice of the input features, the partial products summed over the
    model group (``psum_tp``) before the (replicated) bias; ``"rep"``
    holds the whole leaf.  No collective guards a col layer's input: the
    caller copies it (``ShardCtx.copy_tp``) once for all the col layers
    that read it."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None, mode: str = "rep",
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.mode, self.ctx = mode, ctx
        w_dim, b_dim = LINEAR_DIMS[mode]
        w = _normal(gen, (d_in, d_out), 1 / math.sqrt(d_in), dtype, device)
        self.w = nn.Parameter(ctx.shard(w, w_dim).clone())
        self.b = (nn.Parameter(ctx.shard(torch.zeros(
            d_out, dtype=dtype, device=device), b_dim).clone())
            if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        y = x @ w
        if self.mode == "row":
            y = self.ctx.psum_tp(y)
        return y + self.b if self.b is not None else y


class Embedding(nn.Module):
    """Untied input embedding ``[vocab_padded, d]``, init ``normal * 0.02``.

    Its gradient is the row-sparse tensor Zen synchronizes (leaf
    ``embed/table``).  Padding rows [vocab:) are zero and are never looked
    up, so their gradient is exactly zero.  Under tensor parallelism the
    table is vocab-sharded: rank r holds rows ``[r Vp/tp, (r + 1)
    Vp/tp)`` (the padding rows on the last shard), looks up the tokens
    that fall in them, zeroes the others and sums over the model group
    (the reference's ``embed_lookup``)."""

    def __init__(self, vocab: int, vocab_padded: int, d: int, *,
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.ctx = ctx
        t = _normal(gen, (vocab_padded, d), 0.02, dtype, device)
        t[vocab:] = 0
        self.table = nn.Parameter(ctx.shard(t, 0).clone())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        ctx = self.ctx
        if ctx.tp == 1:
            return F.embedding(tokens, self.table)
        v_local = self.table.shape[0]
        local = tokens - ctx.tp_rank() * v_local
        ok = (local >= 0) & (local < v_local)
        out = F.embedding(local.clamp(0, v_local - 1), self.table)
        return ctx.psum_tp(out * ok[..., None].to(out.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate-half RoPE on x [B, S, H, hd] at positions [S], in f32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs                   # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    backend: str = "cuda", chunk: int = 512,
                    q_chunk: int = 1024) -> torch.Tensor:
    """GQA attention: q [B, Sq, H, hd], k [B, Sk, KV, hd], v [B, Sk, KV,
    hd_v] -> [B, Sq, H, hd_v] in q's dtype, online softmax in f32 (the
    plain version in f64; ``hd_v`` differs from ``hd`` for MLA: 96 and
    64), the reference's
    ``flash_attention`` (its ``chunk`` / ``q_chunk`` blocks are the plain
    version's).

    Under autograd (grad enabled and an input that requires it: every
    trainer's attention) it is ``ops.FlashAttn``, whose forward keeps the
    row log-sum-exp and whose blockwise backward never holds the S x S
    scores.  ``backend="cuda"`` goes through ``ops.flash_fwd_op``: the
    hand-written kernel for CUDA tensors (or an error), the plain version
    for CPU tensors; ``"torch"`` takes the plain version on any device."""
    check_backend(backend)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk,
              q_chunk=q_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return ops.FlashAttn.apply(q, k, v, causal, window, q_offset, chunk,
                                   q_chunk, backend != "cuda")
    if backend == "cuda":
        return ops.flash_fwd_op(q, k, v, **kw)
    return flash_fwd_ref(q, k, v, **kw)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, t: int, *, window: int = 0,
                     ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """One-token attention against a KV cache, sequence-sharded over the
    model axis (the reference's ``decode_attention``).

    q [B, H, hd]; k/v [B, Sl, KV, hd]: this rank's slots; pos [Sl] the
    position each slot holds (-1 = never written).  Attends to slots with
    0 <= pos <= t (and pos > t - window); the current token is in the
    cache already.  The ranks' partial softmaxes are combined by a model
    pmax of the maxima and psums of the sums and the weighted values."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    valid = (pos >= 0) & (pos <= t)
    if window > 0:
        valid &= pos > t - window
    s = torch.where(valid, s, NEG)
    p = torch.exp(s - ctx.pmax_tp(s.max(-1, keepdim=True).values))
    p = torch.where(valid, p, 0.0)
    o = ctx.psum_tp(torch.einsum("bkgs,bskh->bkgh", p, v.float()))
    out = o / ctx.psum_tp(p.sum(-1)).clamp(min=1e-30)[..., None]
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def cache_write(k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, t: int,
                ctx: ShardCtx = ShardCtx()) -> None:
    """Write one token's K/V [B, KV, hd] at position ``t`` IN PLACE on the
    rank that owns it: rank ``t % tp``, slot ``(t // tp) % Sl`` (a ring
    when a sliding window bounds the cache); the other ranks write
    nothing."""
    if t % ctx.tp != ctx.tp_rank():
        return
    slot = (t // ctx.tp) % k.shape[1]
    k[:, slot] = k_new.to(k.dtype)
    v[:, slot] = v_new.to(v.dtype)
    pos[slot] = t


class SwiGLU(nn.Module):
    """``down(silu(gate x) * up x)``: gate and up column-parallel, down
    row-parallel over the model axis."""

    def __init__(self, d: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen, ctx=ctx)
        self.ctx = ctx
        self.gate = Linear(d, d_ff, mode="col", **kw)
        self.up = Linear(d, d_ff, mode="col", **kw)
        self.down = Linear(d_ff, d, mode="row", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ctx.copy_tp(x)
        return self.down(F.silu(self.gate(x)) * self.up(x))


class GeluMLP(nn.Module):
    """Whisper's MLP: ``down(gelu(up(x)))`` with biases; the GELU is the
    tanh form, ``jax.nn.gelu``'s default.  up column-parallel (its bias
    too), down row-parallel over the model axis."""

    def __init__(self, d: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        kw = dict(bias=True, dtype=dtype, device=device, gen=gen, ctx=ctx)
        self.ctx = ctx
        self.up = Linear(d, d_ff, mode="col", **kw)
        self.down = Linear(d_ff, d, mode="row", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(self.ctx.copy_tp(x)),
                                approximate="tanh"))


def mask_padded_logits(lf: torch.Tensor, valid_vocab: int,
                       offset: int = 0) -> torch.Tensor:
    """Padded vocab columns (global id ``offset + column >= valid_vocab``;
    ``offset``: the first id of a vocab shard) to ``NEG``: they vanish
    from the logsumexp and the argmax and carry zero gradient."""
    ok = offset + torch.arange(lf.shape[-1], device=lf.device) < valid_vocab
    return torch.where(ok, lf, torch.full_like(lf, NEG))


def cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor,
                        valid_vocab: int, ctx: ShardCtx = ShardCtx()):
    """(sum of the next-token cross-entropy over labels >= 0, their count),
    in f32, with padded vocab columns masked out, over vocab-sharded
    logits [..., Vp/tp] (``layers.cross_entropy_parts``): a model pmax of
    the row maxima, a psum of the exp-sums and of the label's logit, which
    one rank holds."""
    v_local = logits.shape[-1]
    off = ctx.tp_rank() * v_local
    lf = mask_padded_logits(logits.float(), valid_vocab, off)
    m = ctx.pmax_tp(lf.max(-1).values)
    lse = torch.log(ctx.psum_tp(torch.exp(lf - m[..., None]).sum(-1))) + m
    mask = labels >= 0
    loc = labels - off
    picked = torch.gather(lf, -1, loc.clamp(0, v_local - 1)[..., None])[..., 0]
    if ctx.tp > 1:
        picked = ctx.psum_tp(picked * ((loc >= 0) & (loc < v_local)).float())
    mf = mask.float()
    return ((lse - picked) * mf).sum(), mf.sum()


def _head_chunk_parts(head: Linear, x: torch.Tensor, labels: torch.Tensor,
                      valid_vocab: int, ctx: ShardCtx):
    return cross_entropy_parts(head(x), labels, valid_vocab, ctx)


def lm_head_loss_chunked(head: Linear, x: torch.Tensor, labels: torch.Tensor,
                         valid_vocab: int, ctx: ShardCtx = ShardCtx(), *,
                         chunk: int = 512) -> torch.Tensor:
    """The LM head and the mean cross-entropy, ``chunk`` positions at a
    time (the reference's ``lm_head_loss_chunked``): x [B, S, d] (the
    head's input, copied to the model group by the caller) and labels [B,
    S] (-1 masked) padded to a multiple of the chunk (padded labels -1),
    each chunk's vocab-sharded logits [B, chunk, Vp/tp] and their
    ``cross_entropy_parts`` under ``torch.utils.checkpoint``: the backward
    recomputes them, so at most one chunk's logits are alive, never [B,
    S, Vp/tp].  The chunks' (sum, count) are summed; under tensor
    parallelism each recompute replays its collectives on every rank in
    the same order."""
    B, S, _ = x.shape
    c = min(chunk, S)
    pad = -S % c
    xp = F.pad(x, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad), value=-1)
    total = count = None
    for c0 in range(0, S + pad, c):
        s, n = checkpoint(_head_chunk_parts, head, xp[:, c0:c0 + c],
                          lp[:, c0:c0 + c], valid_vocab, ctx,
                          use_reentrant=False, preserve_rng_state=False)
        total = s if total is None else total + s
        count = n if count is None else count + n
    return total / count.clamp(min=1.0)
