"""Primitive layers of the dense decoder (port of ``repro.models.layers``).

RMSNorm, RoPE, the SwiGLU MLP, the untied input embedding and the LM head
with its cross-entropy.  Tensor parallelism is not ported (ROADMAP queue 1,
item 9), so there are no collectives here.  Numerics follow the reference:
norms and the softmax run in f32, matmuls in the parameters' dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30


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


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` stored [d_in, d_out] as in the reference;
    init ``normal * 1/sqrt(d_in)``, zero bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(_normal(gen, (d_in, d_out), 1 / math.sqrt(d_in),
                                      dtype, device))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y


class Embedding(nn.Module):
    """Untied input embedding ``[vocab_padded, d]``, init ``normal * 0.02``.

    Its gradient is the row-sparse tensor Zen synchronizes (leaf
    ``embed/table``).  Padding rows [vocab:) are zero and are never looked
    up, so their gradient is exactly zero."""

    def __init__(self, vocab: int, vocab_padded: int, d: int, *,
                 dtype=torch.bfloat16, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        t = _normal(gen, (vocab_padded, d), 0.02, dtype, device)
        t[vocab:] = 0
        self.table = nn.Parameter(t)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.table)


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


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.gate = Linear(d, d_ff, **kw)
        self.up = Linear(d, d_ff, **kw)
        self.down = Linear(d_ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


def mask_padded_logits(lf: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """Padded vocab columns (id >= ``valid_vocab``) to ``NEG``: they vanish
    from the logsumexp and carry zero gradient."""
    ok = torch.arange(lf.shape[-1], device=lf.device) < valid_vocab
    return torch.where(ok, lf, torch.full_like(lf, NEG))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid_vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy over labels >= 0, in f32, with padded
    vocab columns masked out (``layers.cross_entropy_parts``)."""
    lf = mask_padded_logits(logits.float(), valid_vocab)
    m = lf.max(-1).values.detach()
    lse = torch.log(torch.exp(lf - m[..., None]).sum(-1)) + m
    mask = labels >= 0
    picked = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mf = mask.float()
    return ((lse - picked) * mf).sum() / mf.sum().clamp(min=1.0)
