"""The port's language models (port of ``repro.models.model`` for
``kind="dense"``, ``"moe"``, ``"ssm"``, ``"hybrid"``, ``"enc_dec"`` and
``"vlm"``).

The input embedding is UNTIED from the LM head: its gradient is row-sparse
(only rows of tokens in the batch are non-zero), which is the tensor Zen
synchronizes (DESIGN.md §4).  Layers are per-layer modules instead of the
reference's stacked ``lax.scan`` arrays; :meth:`Model.load_reference_params`
carries a reference parameter pytree over.

* ``dense``: pre-norm GQA + SwiGLU decoder layers; with ``mla_q_rank``
  set (minicpm3) the attention is MLA (``models/attention.py``), whose
  decode cache is the latent one;
* ``moe``: the same layers with the MoE FFN (``models/moe.py``) in place of
  the SwiGLU;
* ``ssm``: Mamba2 layers;
* ``hybrid`` (zamba2): ``n_layers // shared_attn_every`` groups of
  ``shared_attn_every`` Mamba2 layers, then the remaining tail layers, and
  ONE shared dense decoder layer applied at the start of every group.  The
  shared layer is one set of parameters (one leaf each for GradSync);
  autograd sums its gradient over its applications;
* ``enc_dec`` (whisper): an encoder of ``n_enc_layers`` pre-norm layers
  (non-causal GQA without RoPE, GELU MLP) over the batch's stub ``frames``
  [B, enc_len, d] plus a sinusoidal position table, then ``ln_enc``; the
  decoder layers add a cross-attention block (``lnx``, ``xattn``: K/V
  from the encoder output) between the self-attention and the FFN, which
  is the GELU MLP.  The frames are f32, so the encoder runs in f32
  activations, as JAX's promotion runs the reference's (the dtype choice
  is in ``models/attention.py``'s docstring);
* ``vlm`` (pixtral): a dense decoder whose input is the batch's stub
  ``patches`` [B, P, d] through ``vis_proj`` (no bias), cast to the
  model's dtype, then the token embeddings, at positions 0..P+S-1; the
  patch positions are dropped before the head.

Every path runs the layers in execution order (``Model.exec_layers``: for
the hybrid, the shared layer once per group), and the decode cache holds
one entry per application in that order: K/V for an attention
application (MLA's latent c and RoPE key kr), the SSD state and conv tail
for a Mamba2 layer.

Training: :meth:`Model.train_loss` returns ``(loss, metrics)``: ``loss``
is the differentiated loss (for MoE the LM loss plus ``AUX_LOSS_W`` times
the layers' mean load-balance loss) and ``metrics`` holds ``loss`` (the LM
loss alone, the reference's ``metrics["loss"]``) and, for MoE, the layers'
mean ``moe/aux_loss``, ``moe/dropped`` and ``moe/skew``.  Calling the model
(:meth:`Model.forward`) returns the differentiated loss alone.

Serving: :meth:`Model.prefill` runs the prompt (prefill attention on the
``flash_fwd`` kernel: the encoder's, the decoder's self- and
cross-attention; the Mamba2 scan on ``ssd_fwd``) and returns the decode
cache (an enc_dec layer's entry also holds its cross cache under
``"cross"``; a VLM's ``t`` counts the patch prefix); :meth:`Model.decode`
takes one greedy step (an enc_dec layer's cross-attention is one
``flash_fwd`` at Sq = 1).  The train loss runs every kind with the
reference's memory structure: every attention (the encoder's, the
decoder's self- and cross-attention, the hybrid's shared block, MLA's) is
``flash_fwd`` under autograd (``ops.FlashAttn``: the kernel's forward
keeps the rows' log-sum-exp, the plain blockwise backward never holds the
S x S scores), a Mamba2 layer's scan is ``ssd_fwd`` under autograd
(``ops.SSDScan``, whose gradient is the plain chunked scan's, as the
reference trains by autodiff through that scan), each layer is recomputed
in the backward where the reference has ``jax.checkpoint``
(:func:`recompute`), and the LM head with its loss runs 512 positions at a
time (``layers.lm_head_loss_chunked``).

Tensor parallelism (``ctx``, a ``ShardCtx`` with tp > 1; every kind):
each process holds its rank's shard of every model-sharded leaf and the
whole of every replicated one (:meth:`Model.shard_dims`, the counterpart
of the reference's ``PartitionSpec`` tree).  The embedding, the LM head
(column-parallel) and the loss are vocab-sharded; prefill returns this
rank's vocab shard of the last-position logits (:meth:`Model.gather_vocab`
makes them whole), greedy decode takes the argmax over the shards with
the reference's tie-break, and an attention layer's decode cache holds
``ceil(S / tp)`` slots.  The attention heads (GQA and MLA, the encoder's,
the cross-attention's and the hybrid's shared block's), the MLPs and the
Mamba2 heads are sharded over the model axis as the reference shards
them; the hybrid's shared block is the dense layer's TP, whisper's cross
cache and pixtral's patch prefix (``vis_proj``) are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.hashing import check_backend
from repro_torch.models.attention import (GQA, MLA, gqa_make_cache,
                                          mla_make_cache)
from repro_torch.models.common import ArchConfig, ShardCtx, tp_dim
from repro_torch.models.layers import (Embedding, GeluMLP, Linear, RMSNorm,
                                       SwiGLU, lm_head_loss_chunked,
                                       mask_padded_logits)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2

KINDS = ("dense", "moe", "ssm", "hybrid", "enc_dec", "vlm")
AUX_LOSS_W = 0.01     # the MoE load-balance loss's weight in the train loss


def recompute(layer: nn.Module, x: torch.Tensor, **kw):
    """``layer(x, **kw)``, recomputed in the backward when grad is enabled
    (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint`` around a scanned layer body): the forward keeps
    the layer's input, not its activations.  No layer draws random
    numbers, so the RNG state is not stashed."""
    if not torch.is_grad_enabled():
        return layer(x, **kw)
    return checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def sinusoid_table(T: int, d: int, device=None) -> torch.Tensor:
    """Whisper's encoder position table [T, d] in f32: sin | cos of
    ``t * 10000^(-i / (d/2))``."""
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=device) / half)
    ang = torch.arange(T, device=device).float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncoderLayer(nn.Module):
    """Whisper's encoder block: x + attn(ln1 x) (non-causal, no RoPE),
    then + ffn(ln2 x) (GELU MLP)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = GQA(cfg, device=device, gen=gen, ctx=ctx)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = GeluMLP(cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                           device=device, gen=gen, ctx=ctx)

    def forward(self, x: torch.Tensor, *, backend: str = "cuda"):
        """x [B, T, d] -> [B, T, d], the attention on ``flash_fwd`` (under
        autograd through ``ops.FlashAttn``) on the ``backend`` route."""
        x = x + self.attn(self.ln1(x), causal=False, use_rope=False,
                          backend=backend)
        return x + self.ffn(self.ln2(x))


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1 x), for ``kind="enc_dec"`` then +
    xattn(lnx x) over the encoder output, then + ffn(ln2 x); the attention
    is GQA, or MLA when ``mla_q_rank`` is set; the FFN is a SwiGLU, the MoE
    FFN for ``kind="moe"`` or the GELU MLP for ``"enc_dec"``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        attn = MLA if cfg.mla_q_rank else GQA
        self.attn = attn(cfg, device=device, gen=gen, ctx=ctx)
        self.cross = cfg.kind == "enc_dec"
        if self.cross:
            self.lnx = RMSNorm(cfg.d_model, device=device)
            self.xattn = GQA(cfg, device=device, gen=gen, ctx=ctx)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        kw = dict(dtype=cfg.dtype, device=device, gen=gen, ctx=ctx)
        if cfg.kind == "moe":
            self.ffn = MoE(cfg, device=device, gen=gen, ctx=ctx)
        elif self.cross:
            self.ffn = GeluMLP(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def _ffn(self, x: torch.Tensor):
        """(ffn(x), the MoE stats or {})."""
        if self.cfg.kind == "moe":
            return self.ffn(x)
        return self.ffn(x), {}

    def forward(self, x: torch.Tensor, *, backend: str = "cuda",
                enc_out: torch.Tensor | None = None):
        """x [B, S, d] (and an enc_dec layer's ``enc_out`` [B, T, d]) ->
        (x', stats); the attention (and the cross-attention) on the
        ``backend`` route, ``ops.FlashAttn`` under autograd."""
        x = x + self.attn(self.ln1(x), backend=backend)
        if self.cross:
            x = x + self.xattn(self.lnx(x), kv_src=enc_out, backend=backend)
        y, stats = self._ffn(self.ln2(x))
        return x + y, stats

    def make_cache(self, batch: int, cache_len: int) -> dict:
        """K/V slots (``gqa_make_cache``; MLA's latent slots,
        ``mla_make_cache``: this rank's share under tensor parallelism);
        an enc_dec layer's also a zero cross cache of ``enc_len`` frames
        (every KV head) in the model's dtype."""
        cfg, dev = self.cfg, self.ln1.scale.device
        make = mla_make_cache if cfg.mla_q_rank else gqa_make_cache
        cache = make(cfg, batch, cache_len, device=dev,
                     ctx=self.attn.cache_ctx)
        if self.cross:
            shape = (batch, cfg.enc_len, cfg.n_kv, cfg.hd)
            cache["cross"] = {n: torch.zeros(shape, dtype=cfg.dtype,
                                             device=dev) for n in ("k", "v")}
        return cache

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda",
                enc_out: torch.Tensor | None = None):
        a, cache = self.attn.prefill(self.ln1(x), backend=backend)
        x = x + a
        if self.cross:
            a, cache["cross"] = self.xattn.prefill(
                self.lnx(x), backend=backend, kv_src=enc_out)
            x = x + a
        return x + self._ffn(self.ln2(x))[0], cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0, backend: str = "cuda"):
        x = x + self.attn.decode(self.ln1(x), cache, t, window=window)
        if self.cross:
            x = x + self.xattn.cross_decode(self.lnx(x), cache["cross"],
                                            backend=backend)
        # the FFN sees the step's B tokens as [B, 1, d] (MoE: T = B)
        return x + self._ffn(self.ln2(x)[:, None])[0][:, 0], cache


class SSMLayer(nn.Module):
    """Pre-norm Mamba2 block: x + mixer(ln1 x)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mixer = Mamba2(cfg, device=device, gen=gen, ctx=ctx)

    def forward(self, x: torch.Tensor, *, backend: str = "cuda"):
        """x [B, S, d] -> (x', {})."""
        return x + self.mixer(self.ln1(x), backend=backend), {}

    def make_cache(self, batch: int, cache_len: int) -> dict:
        return self.mixer.make_cache(batch)

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        y, cache = self.mixer(self.ln1(x), return_cache=True, backend=backend)
        return x + y, cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0, backend: str = "cuda"):
        y, cache = self.mixer.decode(self.ln1(x), cache)
        return x + y, cache


class Model(nn.Module):
    """Dense or MoE decoder, Mamba2 LM, zamba2 hybrid, whisper
    encoder-decoder or pixtral VLM backbone;
    :meth:`train_loss` (and calling the model) is the train loss of a
    batch, :meth:`prefill` / :meth:`decode` serve.

    Built on ``cuda`` unless ``device="cpu"`` is passed (or ``"meta"``:
    shapes without values, ``launch/dryrun.py``); parameters are drawn
    from a ``torch.Generator`` seeded with ``seed``.  ``backend``
    picks the model kernels' route (attention and the Mamba2 scan, in
    prefill and in the train loss): ``"cuda"`` (the hand-written kernels
    for CUDA tensors, their plain versions for CPU ones) or ``"torch"``
    (the plain versions).  ``ctx`` (default: tp = 1) is the shard
    context: at tp > 1 this process builds its model rank's shards,
    drawing each sharded leaf whole and keeping its slice."""

    sparse_paths = ("embed/table",)

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 backend: str = "cuda", ctx: ShardCtx = ShardCtx()):
        super().__init__()
        if cfg.kind not in KINDS:
            raise NotImplementedError(
                f"model kind {cfg.kind!r} is not ported yet (ROADMAP queue "
                f"1, item 9); the port runs {KINDS}")
        check_backend(backend)
        self.cfg, self.backend, self.ctx = cfg, backend, ctx
        device = resolve_device(device)
        # the meta device (the dry run's) has no generator: its draws take
        # a host one, whose values it never makes
        gen = torch.Generator(device="cpu" if device.type == "meta"
                              else device).manual_seed(seed)
        vp = cfg.vocab_padded
        self.embed = Embedding(cfg.vocab, vp, cfg.d_model, dtype=cfg.dtype,
                               device=device, gen=gen, ctx=ctx)
        kw = dict(device=device, gen=gen, ctx=ctx)
        if cfg.kind == "hybrid":
            every = cfg.shared_attn_every
            n_groups = cfg.n_layers // every
            self.groups = nn.ModuleList(
                nn.ModuleList(SSMLayer(cfg, **kw) for _ in range(every))
                for _ in range(n_groups))
            self.tail = nn.ModuleList(
                SSMLayer(cfg, **kw)
                for _ in range(cfg.n_layers - n_groups * every))
            self.shared = DecoderLayer(
                dataclasses.replace(cfg, kind="dense"), **kw)
            # the shared layer at the start of every group
            self.exec_layers = [ly for g in self.groups
                                for ly in (self.shared, *g)] + [*self.tail]
        else:
            if cfg.kind == "enc_dec":
                self.enc_layers = nn.ModuleList(
                    EncoderLayer(cfg, **kw) for _ in range(cfg.n_enc_layers))
                self.ln_enc = RMSNorm(cfg.d_model, device=device)
            self.layers = nn.ModuleList(
                (SSMLayer if cfg.kind == "ssm" else DecoderLayer)(cfg, **kw)
                for _ in range(cfg.n_layers))
            self.exec_layers = list(self.layers)
        if cfg.kind == "vlm":   # replicated, as every rank's patches
            self.vis_proj = Linear(cfg.d_model, cfg.d_model, **kw,
                                   dtype=cfg.dtype)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.lm_head = Linear(cfg.d_model, vp, dtype=cfg.dtype, device=device,
                              gen=gen, mode="col", ctx=ctx)
        with torch.no_grad():   # padded vocab columns start (and stay) zero
            self.lm_head.w[:, max(cfg.vocab - self._vocab_offset(), 0):] = 0

    def _vocab_offset(self) -> int:
        """The first vocab id of this rank's shard."""
        return self.ctx.tp_rank() * (self.cfg.vocab_padded // self.ctx.tp)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over stub frames [B, T, d] (f32: the
        activations stay f32, as the reference's): the sinusoidal table
        added, the encoder layers (``flash_fwd`` on the model's route;
        each recomputed in the backward when grad is enabled, the
        reference's ``jax.checkpoint``), ``ln_enc``."""
        x = frames + sinusoid_table(frames.shape[1], self.cfg.d_model,
                                    frames.device).to(frames.dtype)
        for layer in self.enc_layers:
            x = recompute(layer, x, backend=self.backend)
        return self.ln_enc(x)

    def _inputs(self, tokens: torch.Tensor, patches: torch.Tensor | None):
        """The first layer's input: the token embeddings, after a VLM's
        projected patch prefix (cast to the model's dtype)."""
        x = self.embed(tokens)
        if self.cfg.kind == "vlm":
            x = torch.cat([self.vis_proj(patches).to(x.dtype), x], dim=1)
        return x

    def train_loss(self, tokens: torch.Tensor, labels: torch.Tensor, *,
                   frames: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None):
        """tokens/labels [B, S] (labels -1 masked; whisper adds ``frames``
        [B, T, d], pixtral ``patches`` [B, P, d]) -> (differentiated loss,
        metrics): embed, the layers, ``ln_f``, the untied head (on the
        token positions only) with the mean next-token cross-entropy
        (``metrics["loss"]``), for MoE plus ``AUX_LOSS_W`` x the layers'
        mean ``moe/aux_loss`` (``metrics`` also holds the layers' mean MoE
        stats).  The step's memory is the reference's: every layer
        application but the hybrid's shared block is recomputed in the
        backward (:func:`recompute`, where the reference has
        ``jax.checkpoint``), attention keeps O(S) a row
        (``ops.FlashAttn``), and the head runs 512 positions at a time
        (``layers.lm_head_loss_chunked``)."""
        x = self._inputs(tokens, patches)
        kw = ({"enc_out": self.encode(frames)} if self.cfg.kind == "enc_dec"
              else {})
        stats = []
        for layer in self.exec_layers:
            if layer is getattr(self, "shared", None):
                # the reference applies the shared block outside any
                # checkpoint (its ``group_body``)
                x, st = layer(x, backend=self.backend, **kw)
            else:
                x, st = recompute(layer, x, backend=self.backend, **kw)
            if st:
                stats.append(st)
        h = self.ln_f(x[:, x.shape[1] - tokens.shape[1]:])
        loss = lm_head_loss_chunked(self.lm_head, self.ctx.copy_tp(h), labels,
                                    self.cfg.vocab, self.ctx)
        metrics = {"loss": loss}
        if stats:
            metrics.update({k: torch.stack([s[k] for s in stats]).mean()
                            for k in stats[0]})
            loss = loss + AUX_LOSS_W * metrics["moe/aux_loss"]
        return loss, metrics

    def forward(self, tokens: torch.Tensor, labels: torch.Tensor,
                **inputs) -> torch.Tensor:
        """The differentiated loss of :meth:`train_loss`."""
        return self.train_loss(tokens, labels, **inputs)[0]

    # ---- serving -----------------------------------------------------------

    def _head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM-head logits (this rank's vocab shard) with padded vocab
        columns masked to NEG."""
        return mask_padded_logits(self.lm_head(self.ln_f(x)), self.cfg.vocab,
                                  self._vocab_offset())

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[..., Vp/tp] vocab shards -> [..., Vp] on every rank."""
        if self.ctx.tp == 1:
            return logits
        lt = logits.movedim(-1, 0)
        return self.ctx.all_gather_tp(lt).movedim(0, -1)

    @torch.inference_mode()
    def make_cache(self, batch: int, cache_len: int) -> dict:
        """An empty decode cache: ``t = 0`` and, per layer application in
        execution order, zero K/V with every slot's position -1 (attention,
        ``cache_len`` slots, ``ceil(cache_len / tp)`` a rank under tensor
        parallelism, MLA's latent c and kr; an enc_dec layer's also a zero
        cross cache) or a zero SSD state and conv tail (Mamba2)."""
        return {"t": 0, "layers": [ly.make_cache(batch, cache_len)
                                   for ly in self.exec_layers]}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None):
        """Run the prompt tokens [B, S] (whisper: after encoding ``frames``;
        pixtral: after the ``patches`` prefix of P positions); returns
        (last-position logits [B, vocab_padded / tp] in the model's dtype,
        this rank's vocab shard, padded columns masked, and the decode
        cache with ``t`` = S (P + S for a VLM): per layer application the
        prompt's K/V and positions 0..t-1, this rank's round-robin share
        of them under tensor parallelism (and an enc_dec layer's cross
        cache), or the final SSD state and conv tail)."""
        x = self._inputs(tokens, patches)
        kw = ({"enc_out": self.encode(frames)}
              if self.cfg.kind == "enc_dec" else {})
        caches = []
        for layer in self.exec_layers:
            x, c = layer.prefill(x, backend=self.backend, **kw)
            caches.append(c)
        return self._head_logits(x[:, -1]), {"t": x.shape[1],
                                             "layers": caches}

    @torch.inference_mode()
    def decode(self, cache: dict, tokens: torch.Tensor, *, window: int = 0,
               return_gap: bool = False):
        """One greedy step: tokens [B, 1] at position ``cache["t"]`` ->
        (next [B, 1], max logit [B] f32, cache).  The cache is updated IN
        PLACE (K/V slots written, SSD state replaced, ``t`` + 1) and
        returned.  ``return_gap`` adds the top-1 minus top-2 logit [B]."""
        t = cache["t"]
        x = self.embed(tokens)[:, 0]
        for i, layer in enumerate(self.exec_layers):
            x, cache["layers"][i] = layer.decode(x, cache["layers"][i], t,
                                                 window=window,
                                                 backend=self.backend)
        cache["t"] = t + 1
        lf = self._head_logits(x).float()
        m, nxt = lf.max(-1)
        ctx = self.ctx
        if ctx.tp > 1:   # the reference's tie-break: the highest shard's
            m_l, m = m, ctx.pmax_tp(m)
            nxt = ctx.pmax_tp(torch.where(m_l >= m,
                                          nxt + self._vocab_offset(), 0))
        if not return_gap:
            return nxt[:, None], m, cache
        top = self.gather_vocab(lf).topk(2, dim=-1).values
        return nxt[:, None], m, cache, top[:, 0] - top[:, 1]

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """Parameters under '/'-joined names (``embed/table``, ...), the
        naming GradSync's sparse paths match; the hybrid's shared layer is
        one set of leaves (``shared/...``)."""
        return [(n.replace(".", "/"), p) for n, p in self.named_parameters()]

    def reference_leaves(self) -> list[tuple[str, tuple, tuple]]:
        """(leaf name, the reference's path of the leaf, the index into its
        stacked dims) for every leaf: layers stacked [L, ...] by
        ``lax.scan``; the hybrid's ``groups/inner`` stacked [groups,
        every, ...], ``tail`` [n_tail, ...] and ``shared`` unstacked;
        whisper's ``enc_layers`` stacked, ``ln_enc``, and each decoder
        layer's ``lnx`` and ``xattn``; pixtral's ``vis_proj_w``; MLA's
        five projections and two norms."""
        out = []

        def linears(mod: nn.Module, names, pre: tuple, idx: tuple) -> None:
            for name in names:
                lin = getattr(mod, name)
                out.append((lin.w, (*pre, f"{name}_w"), idx))
                if lin.b is not None:
                    out.append((lin.b, (*pre, f"{name}_b"), idx))

        def ssm(layer: SSMLayer, pre: tuple, idx: tuple) -> None:
            out.append((layer.ln1.scale, (*pre, "ln1"), idx))
            mix = (*pre, "mixer")
            linears(layer.mixer, ("in_z", "in_x", "in_dt", "in_bc", "out"),
                    mix, idx)
            out.extend((getattr(layer.mixer, n), (*mix, n), idx)
                       for n in ("conv_w", "conv_b", "A_log", "dt_bias", "D",
                                 "norm"))

        def decoder(layer: DecoderLayer | EncoderLayer, pre: tuple,
                    idx: tuple) -> None:
            out.extend((getattr(layer, n).scale, (*pre, n), idx)
                       for n in ("ln1", "ln2"))
            attn = (*pre, "attn")
            if isinstance(layer.attn, MLA):
                linears(layer.attn, ("q_down", "q_up", "kv_down", "kv_up",
                                     "o"), attn, idx)
                out.extend((getattr(layer.attn, n).scale, (*attn, n), idx)
                           for n in ("q_norm", "kv_norm"))
            else:
                linears(layer.attn, "qkvo", attn, idx)
            if getattr(layer, "cross", False):
                out.append((layer.lnx.scale, (*pre, "lnx"), idx))
                linears(layer.xattn, "qkvo", (*pre, "xattn"), idx)
            if isinstance(layer.ffn, MoE):
                out.extend((getattr(layer.ffn, n), (*pre, "ffn", n), idx)
                           for n in ("router_w", "w_gate", "w_up", "w_down"))
            else:
                linears(layer.ffn, ("up", "down") if isinstance(
                    layer.ffn, GeluMLP) else ("gate", "up", "down"),
                    (*pre, "ffn"), idx)

        out += [(self.embed.table, ("embed", "table"), ()),
                (self.lm_head.w, ("lm_head_w",), ()),
                (self.ln_f.scale, ("ln_f",), ())]
        if self.cfg.kind == "hybrid":
            for g, group in enumerate(self.groups):
                for j, layer in enumerate(group):
                    ssm(layer, ("groups", "inner"), (g, j))
            for i, layer in enumerate(self.tail):
                ssm(layer, ("tail",), (i,))
            decoder(self.shared, ("shared",), ())
        else:
            if self.cfg.kind == "enc_dec":
                for i, layer in enumerate(self.enc_layers):
                    decoder(layer, ("enc_layers",), (i,))
                out.append((self.ln_enc.scale, ("ln_enc",), ()))
            if self.cfg.kind == "vlm":
                out.append((self.vis_proj.w, ("vis_proj_w",), ()))
            for i, layer in enumerate(self.layers):
                (ssm if self.cfg.kind == "ssm" else decoder)(
                    layer, ("layers",), (i,))
        names = {id(p): n for n, p in self.named_leaves()}
        return [(names[id(p)], path, idx) for p, path, idx in out]

    def shard_dims(self, ctx: ShardCtx | None = None) -> dict:
        """{leaf name: its model-sharded dim, None if replicated} under
        ``ctx`` (default the model's): the reference's ``PartitionSpec``
        tree (``models/common.tp_dim``), per leaf."""
        ctx = ctx or self.ctx
        return {n: tp_dim(path, ctx) for n, path, _ in self.reference_leaves()}

    @torch.no_grad()
    def load_reference_params(self, tree: Any) -> None:
        """Copy the reference's GLOBAL parameter pytree (arrays or numpy
        arrays, :meth:`reference_leaves`' layout) into this model: each
        leaf sliced to this rank's shard of its sharded dim."""
        params, dims = dict(self.named_leaves()), self.shard_dims()
        leaves = self.reference_leaves()
        if len(leaves) != len(params):
            raise ValueError(f"{len(params) - len(leaves)} leaves have no "
                             f"reference path")
        for name, path, idx in leaves:
            node = tree
            for key in path:
                node = node[key]
            a = np.asarray(node)[idx] if idx else node
            a = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
            a = self.ctx.shard(a, dims[name])
            p = params[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"reference leaf {'/'.join(path)} shard "
                                 f"{tuple(a.shape)} != {tuple(p.shape)}")
            p.copy_(a.to(p.dtype))
