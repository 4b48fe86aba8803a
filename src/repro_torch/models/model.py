"""The port's language models (port of ``repro.models.model`` for
``kind="dense"`` and ``kind="ssm"``).

The input embedding is UNTIED from the LM head: its gradient is row-sparse
(only rows of tokens in the batch are non-zero), which is the tensor Zen
synchronizes (DESIGN.md §4).  Layers are per-layer modules instead of the
reference's stacked ``lax.scan`` arrays; :meth:`Model.load_reference_params`
carries a reference parameter pytree over.

Serving: :meth:`Model.prefill` runs the prompt (prefill attention on the
``flash_fwd`` kernel, the Mamba2 scan on ``ssd_fwd``) and returns the
decode cache; :meth:`Model.decode` takes one greedy step.  The train loss
runs both kinds; a Mamba2 layer's scan is ``ssd_fwd`` under autograd
(``ops.SSDScan``), whose gradient is the plain chunked scan's, as the
reference trains by autodiff through that scan.
"""
from __future__ import annotations

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
from repro_torch.models.ssm import Mamba2

KINDS = ("dense", "ssm")


class DecoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1 x), then + swiglu(ln2 x)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = GQA(cfg, device=device, gen=gen)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.dtype,
                          device=device, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.ffn(self.ln2(x))

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        a, cache = self.attn.prefill(self.ln1(x), backend=backend)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0):
        x = x + self.attn.decode(self.ln1(x), cache, t, window=window)
        return x + self.ffn(self.ln2(x)), cache


class SSMLayer(nn.Module):
    """Pre-norm Mamba2 block: x + mixer(ln1 x)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.mixer = Mamba2(cfg, device=device, gen=gen)

    def forward(self, x: torch.Tensor, *,
                backend: str = "cuda") -> torch.Tensor:
        return x + self.mixer(self.ln1(x), backend=backend)

    def prefill(self, x: torch.Tensor, *, backend: str = "cuda"):
        y, cache = self.mixer(self.ln1(x), return_cache=True, backend=backend)
        return x + y, cache

    def decode(self, x: torch.Tensor, cache: dict, t: int, *,
               window: int = 0):
        y, cache = self.mixer.decode(self.ln1(x), cache)
        return x + y, cache


class Model(nn.Module):
    """Dense decoder or Mamba2 LM; :meth:`forward` is the train loss of a
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
        layer = SSMLayer if cfg.kind == "ssm" else DecoderLayer
        self.layers = nn.ModuleList(
            layer(cfg, device=device, gen=gen) for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.lm_head = Linear(cfg.d_model, vp, dtype=cfg.dtype, device=device,
                              gen=gen)
        with torch.no_grad():   # padded vocab columns start (and stay) zero
            self.lm_head.w[:, cfg.vocab:] = 0

    def forward(self, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token loss of tokens/labels [B, S] (labels -1 masked):
        embed, the layers, ``ln_f``, the untied head, cross-entropy."""
        x = self.embed(tokens)
        kw = {"backend": self.backend} if self.cfg.kind == "ssm" else {}
        for layer in self.layers:
            x = layer(x, **kw)
        logits = self.lm_head(self.ln_f(x))
        return cross_entropy(logits, labels, self.cfg.vocab)

    # ---- serving -----------------------------------------------------------

    def _head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """LM-head logits with padded vocab columns masked to NEG."""
        return mask_padded_logits(self.lm_head(self.ln_f(x)), self.cfg.vocab)

    @torch.inference_mode()
    def make_cache(self, batch: int, cache_len: int) -> dict:
        """An empty decode cache: ``t = 0`` and, per layer, zero K/V with
        every slot's position -1 (dense, ``cache_len`` slots) or a zero SSD
        state and conv tail (ssm)."""
        dev = self.embed.table.device
        if self.cfg.kind == "ssm":
            layers = [ly.mixer.make_cache(batch) for ly in self.layers]
        else:
            layers = [gqa_make_cache(self.cfg, batch, cache_len, device=dev)
                      for _ in self.layers]
        return {"t": 0, "layers": layers}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        """Run the prompt tokens [B, S]; returns (last-position logits
        [B, vocab_padded] in the model's dtype, padded columns masked, and
        the decode cache with ``t = S``: per layer the prompt's K/V and
        positions 0..S-1, or the final SSD state and conv tail)."""
        x = self.embed(tokens)
        caches = []
        for layer in self.layers:
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
        for i, layer in enumerate(self.layers):
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
        naming GradSync's sparse paths match."""
        return [(n.replace(".", "/"), p) for n, p in self.named_parameters()]

    @torch.no_grad()
    def load_reference_params(self, tree: Any) -> None:
        """Copy the reference's parameter pytree (arrays or numpy arrays;
        layers stacked [L, ...] by ``lax.scan``) into this model."""
        def put(p: torch.Tensor, x) -> None:
            a = torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"reference leaf shape {tuple(a.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(a.to(p.dtype))

        put(self.embed.table, tree["embed"]["table"])
        put(self.lm_head.w, tree["lm_head_w"])
        put(self.ln_f.scale, tree["ln_f"])
        ly = tree["layers"]
        if self.cfg.kind == "ssm":
            for i, layer in enumerate(self.layers):
                put(layer.ln1.scale, ly["ln1"][i])
                mx, mix = ly["mixer"], layer.mixer
                for name in ("in_z", "in_x", "in_dt", "in_bc", "out"):
                    put(getattr(mix, name).w, mx[f"{name}_w"][i])
                for name in ("conv_w", "conv_b", "A_log", "dt_bias", "D",
                             "norm"):
                    put(getattr(mix, name), mx[name][i])
            return
        for i, layer in enumerate(self.layers):
            put(layer.ln1.scale, ly["ln1"][i])
            put(layer.ln2.scale, ly["ln2"][i])
            for name in ("q", "k", "v", "o"):
                lin = getattr(layer.attn, name)
                put(lin.w, ly["attn"][f"{name}_w"][i])
                if lin.b is not None:
                    put(lin.b, ly["attn"][f"{name}_b"][i])
            for name in ("gate", "up", "down"):
                put(getattr(layer.ffn, name).w, ly["ffn"][f"{name}_w"][i])
