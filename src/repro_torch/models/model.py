"""The port's language models (port of ``repro.models.model`` for
``kind="dense"``, ``"moe"``, ``"ssm"`` and ``"hybrid"``).

The input embedding is UNTIED from the LM head: its gradient is row-sparse
(only rows of tokens in the batch are non-zero), which is the tensor Zen
synchronizes (DESIGN.md §4).  Layers are per-layer modules instead of the
reference's stacked ``lax.scan`` arrays; :meth:`Model.load_reference_params`
carries a reference parameter pytree over.

* ``dense``: pre-norm GQA + SwiGLU decoder layers;
* ``moe``: the same layers with the MoE FFN (``models/moe.py``) in place of
  the SwiGLU;
* ``ssm``: Mamba2 layers;
* ``hybrid`` (zamba2): ``n_layers // shared_attn_every`` groups of
  ``shared_attn_every`` Mamba2 layers, then the remaining tail layers, and
  ONE shared dense decoder layer applied at the start of every group.  The
  shared layer is one set of parameters (one leaf each for GradSync);
  autograd sums its gradient over its applications.

Every path runs the layers in execution order (``Model.exec_layers``: for
the hybrid, the shared layer once per group), and the decode cache holds
one entry per application in that order: K/V for an attention
application, the SSD state and conv tail for a Mamba2 layer.

Training: :meth:`Model.train_loss` returns ``(loss, metrics)``: ``loss``
is the differentiated loss (for MoE the LM loss plus ``AUX_LOSS_W`` times
the layers' mean load-balance loss) and ``metrics`` holds ``loss`` (the LM
loss alone, the reference's ``metrics["loss"]``) and, for MoE, the layers'
mean ``moe/aux_loss``, ``moe/dropped`` and ``moe/skew``.  Calling the model
(:meth:`Model.forward`) returns the differentiated loss alone.

Serving: :meth:`Model.prefill` runs the prompt (prefill attention on the
``flash_fwd`` kernel, the Mamba2 scan on ``ssd_fwd``) and returns the
decode cache; :meth:`Model.decode` takes one greedy step.  The train loss
runs every kind; a Mamba2 layer's scan is ``ssd_fwd`` under autograd
(``ops.SSDScan``), whose gradient is the plain chunked scan's, as the
reference trains by autodiff through that scan.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core.hashing import check_backend
from repro_torch.models.attention import GQA, gqa_make_cache
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (Embedding, Linear, RMSNorm, SwiGLU,
                                       cross_entropy, mask_padded_logits)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2

KINDS = ("dense", "moe", "ssm", "hybrid")
AUX_LOSS_W = 0.01     # the MoE load-balance loss's weight in the train loss


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1 x), then + ffn(ln2 x); the FFN is a
    SwiGLU, or the MoE FFN for ``kind="moe"``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = GQA(cfg, device=device, gen=gen)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        if cfg.kind == "moe":
            self.ffn = MoE(cfg, device=device, gen=gen)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                              device=device, gen=gen)

    def _ffn(self, x: torch.Tensor):
        """(ffn(x), the MoE stats or {})."""
        if self.cfg.kind == "moe":
            return self.ffn(x)
        return self.ffn(x), {}

    def forward(self, x: torch.Tensor, *, backend: str = "cuda"):
        """x [B, S, d] -> (x', stats); the trainer's attention is plain
        (``GQA.forward``), so ``backend`` changes nothing here."""
        x = x + self.attn(self.ln1(x))
        y, stats = self._ffn(self.ln2(x))
        return x + y, stats

    def make_cache(self, batch: int, cache_len: int) -> dict:
        return gqa_make_cache(self.cfg, batch, cache_len,
                              device=self.ln1.scale.device)

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        a, cache = self.attn.prefill(self.ln1(x), backend=backend)
        x = x + a
        return x + self._ffn(self.ln2(x))[0], cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0):
        x = x + self.attn.decode(self.ln1(x), cache, t, window=window)
        # the FFN sees the step's B tokens as [B, 1, d] (MoE: T = B)
        return x + self._ffn(self.ln2(x)[:, None])[0][:, 0], cache


class SSMLayer(nn.Module):
    """Pre-norm Mamba2 block: x + mixer(ln1 x)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mixer = Mamba2(cfg, device=device, gen=gen)

    def forward(self, x: torch.Tensor, *, backend: str = "cuda"):
        """x [B, S, d] -> (x', {})."""
        return x + self.mixer(self.ln1(x), backend=backend), {}

    def make_cache(self, batch: int, cache_len: int) -> dict:
        return self.mixer.make_cache(batch)

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        y, cache = self.mixer(self.ln1(x), return_cache=True, backend=backend)
        return x + y, cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0):
        y, cache = self.mixer.decode(self.ln1(x), cache)
        return x + y, cache


class Model(nn.Module):
    """Dense or MoE decoder, Mamba2 LM or zamba2 hybrid;
    :meth:`train_loss` (and calling the model) is the train loss of a
    batch, :meth:`prefill` / :meth:`decode` serve.

    Built on ``cuda`` unless ``device="cpu"`` is passed; parameters are
    drawn from a ``torch.Generator`` seeded with ``seed``.  ``backend``
    picks the model kernels' route (prefill, and the Mamba2 scan in the
    train loss): ``"cuda"`` (the hand-written kernels for CUDA tensors,
    their plain versions for CPU ones) or ``"torch"`` (the plain
    versions)."""

    sparse_paths = ("embed/table",)

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 backend: str = "cuda"):
        super().__init__()
        if cfg.kind not in KINDS:
            raise NotImplementedError(
                f"model kind {cfg.kind!r} is not ported yet (ROADMAP queue "
                f"1, item 9); the port runs {KINDS}")
        check_backend(backend)
        self.cfg, self.backend = cfg, backend
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        vp = cfg.vocab_padded
        self.embed = Embedding(cfg.vocab, vp, cfg.d_model, dtype=cfg.dtype,
                               device=device, gen=gen)
        kw = dict(device=device, gen=gen)
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
            layer = SSMLayer if cfg.kind == "ssm" else DecoderLayer
            self.layers = nn.ModuleList(
                layer(cfg, **kw) for _ in range(cfg.n_layers))
            self.exec_layers = list(self.layers)
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.lm_head = Linear(cfg.d_model, vp, dtype=cfg.dtype, device=device,
                              gen=gen)
        with torch.no_grad():   # padded vocab columns start (and stay) zero
            self.lm_head.w[:, cfg.vocab:] = 0

    def train_loss(self, tokens: torch.Tensor, labels: torch.Tensor):
        """tokens/labels [B, S] (labels -1 masked) -> (differentiated loss,
        metrics): embed, the layers, ``ln_f``, the untied head, the mean
        next-token cross-entropy (``metrics["loss"]``), for MoE plus
        ``AUX_LOSS_W`` x the layers' mean ``moe/aux_loss`` (``metrics``
        also holds the layers' mean MoE stats)."""
        x = self.embed(tokens)
        stats = []
        for layer in self.exec_layers:
            x, st = layer(x, backend=self.backend)
            if st:
                stats.append(st)
        logits = self.lm_head(self.ln_f(x))
        loss = cross_entropy(logits, labels, self.cfg.vocab)
        metrics = {"loss": loss}
        if stats:
            metrics.update({k: torch.stack([s[k] for s in stats]).mean()
                            for k in stats[0]})
            loss = loss + AUX_LOSS_W * metrics["moe/aux_loss"]
        return loss, metrics

    def forward(self, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """The differentiated loss of :meth:`train_loss`."""
        return self.train_loss(tokens, labels)[0]

    # ---- serving -----------------------------------------------------------

    def _head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM-head logits with padded vocab columns masked to NEG."""
        return mask_padded_logits(self.lm_head(self.ln_f(x)), self.cfg.vocab)

    @torch.inference_mode()
    def make_cache(self, batch: int, cache_len: int) -> dict:
        """An empty decode cache: ``t = 0`` and, per layer application in
        execution order, zero K/V with every slot's position -1 (attention,
        ``cache_len`` slots) or a zero SSD state and conv tail (Mamba2)."""
        return {"t": 0, "layers": [ly.make_cache(batch, cache_len)
                                   for ly in self.exec_layers]}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """Run the prompt tokens [B, S]; returns (last-position logits
        [B, vocab_padded] in the model's dtype, padded columns masked, and
        the decode cache with ``t = S``: per layer application the prompt's
        K/V and positions 0..S-1, or the final SSD state and conv tail)."""
        x = self.embed(tokens)
        caches = []
        for layer in self.exec_layers:
            x, c = layer.prefill(x, backend=self.backend)
            caches.append(c)
        return self._head_logits(x[:, -1]), {"t": tokens.shape[1],
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
                                                 window=window)
        cache["t"] = t + 1
        lf = self._head_logits(x).float()
        m, nxt = lf.max(-1)
        if not return_gap:
            return nxt[:, None], m, cache
        top = lf.topk(2, dim=-1).values
        return nxt[:, None], m, cache, top[:, 0] - top[:, 1]

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """Parameters under '/'-joined names (``embed/table``, ...), the
        naming GradSync's sparse paths match; the hybrid's shared layer is
        one set of leaves (``shared/...``)."""
        return [(n.replace(".", "/"), p) for n, p in self.named_parameters()]

    @torch.no_grad()
    def load_reference_params(self, tree: Any) -> None:
        """Copy the reference's parameter pytree (arrays or numpy arrays;
        layers stacked [L, ...] by ``lax.scan``; the hybrid's
        ``groups/inner`` stacked [groups, every, ...], ``tail`` [n_tail,
        ...] and ``shared`` unstacked) into this model."""
        def put(p: torch.Tensor, x) -> None:
            a = torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"reference leaf shape {tuple(a.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(a.to(p.dtype))

        def put_ssm(layer: SSMLayer, ly, at) -> None:
            put(layer.ln1.scale, at(ly["ln1"]))
            mx, mix = ly["mixer"], layer.mixer
            for name in ("in_z", "in_x", "in_dt", "in_bc", "out"):
                put(getattr(mix, name).w, at(mx[f"{name}_w"]))
            for name in ("conv_w", "conv_b", "A_log", "dt_bias", "D",
                         "norm"):
                put(getattr(mix, name), at(mx[name]))

        def put_decoder(layer: DecoderLayer, ly, at) -> None:
            put(layer.ln1.scale, at(ly["ln1"]))
            put(layer.ln2.scale, at(ly["ln2"]))
            for name in ("q", "k", "v", "o"):
                lin = getattr(layer.attn, name)
                put(lin.w, at(ly["attn"][f"{name}_w"]))
                if lin.b is not None:
                    put(lin.b, at(ly["attn"][f"{name}_b"]))
            if layer.cfg.kind == "moe":
                for name in ("router_w", "w_gate", "w_up", "w_down"):
                    put(getattr(layer.ffn, name), at(ly["ffn"][name]))
                return
            for name in ("gate", "up", "down"):
                put(getattr(layer.ffn, name).w, at(ly["ffn"][f"{name}_w"]))

        put(self.embed.table, tree["embed"]["table"])
        put(self.lm_head.w, tree["lm_head_w"])
        put(self.ln_f.scale, tree["ln_f"])
        if self.cfg.kind == "hybrid":
            for g, group in enumerate(self.groups):
                for j, layer in enumerate(group):
                    put_ssm(layer, tree["groups"]["inner"],
                            lambda a, g=g, j=j: np.asarray(a)[g, j])
            for i, layer in enumerate(self.tail):
                put_ssm(layer, tree["tail"], lambda a, i=i: np.asarray(a)[i])
            put_decoder(self.shared, tree["shared"], lambda a: a)
            return
        fill = put_ssm if self.cfg.kind == "ssm" else put_decoder
        for i, layer in enumerate(self.layers):
            fill(layer, tree["layers"], lambda a, i=i: np.asarray(a)[i])
