"""The dense decoder (port of ``repro.models.model`` for ``kind="dense"``).

The input embedding is UNTIED from the LM head: its gradient is row-sparse
(only rows of tokens in the batch are non-zero), which is the tensor Zen
synchronizes (DESIGN.md §4).  Layers are per-layer modules instead of the
reference's stacked ``lax.scan`` arrays; :meth:`Model.load_reference_params`
carries a reference parameter pytree over.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.attention import GQA
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (Embedding, Linear, RMSNorm, SwiGLU,
                                       cross_entropy)


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


class Model(nn.Module):
    """Dense decoder LM; :meth:`forward` is the train loss of a batch.

    Built on ``cuda`` unless ``device="cpu"`` is passed; parameters are
    drawn from a ``torch.Generator`` seeded with ``seed``."""

    sparse_paths = ("embed/table",)

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.kind != "dense":
            raise NotImplementedError(
                f"model kind {cfg.kind!r} is not ported yet (ROADMAP queue "
                f"1, item 9); the port runs dense decoders")
        self.cfg = cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        vp = cfg.vocab_padded
        self.embed = Embedding(cfg.vocab, vp, cfg.d_model, dtype=cfg.dtype,
                               device=device, gen=gen)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, gen=gen)
            for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.lm_head = Linear(cfg.d_model, vp, dtype=cfg.dtype, device=device,
                              gen=gen)
        with torch.no_grad():   # padded vocab columns start (and stay) zero
            self.lm_head.w[:, cfg.vocab:] = 0

    def forward(self, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token loss of tokens/labels [B, S] (labels -1 masked)."""
        x = self.embed(tokens)
        for layer in self.layers:
            x = layer(x)
        logits = self.lm_head(self.ln_f(x))
        return cross_entropy(logits, labels, self.cfg.vocab)

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
