"""Plain reference of a dense GQA decoder with RoPE and a SwiGLU MLP (the
Qwen2 and Phi-3 families as the port builds them), one sequence at a
time, in float32 with TF32 off; written from the architecture, not from
the port, and importing nothing of it.

A layer: ``h = x + o(attn(rms(x) * ln1))``, ``x' = h + down(silu(gate(
rms(h) * ln2)) * up(rms(h) * ln2))``; q, k, v with a bias where the
configuration has ``attention_bias``; rotate-half RoPE on q and k at
positions 0..S-1 (angles in float64, then float32); causal softmax
attention scaled by 1/sqrt(head dim), each KV head shared by H / KV
consecutive q heads; ``rms(x) = x / sqrt(mean(x^2) + eps)``.  The head
``rms(x) * ln_f @ lm_head`` gives logits over the padded vocabulary whose
padding columns are masked out; the loss is the mean next-token
cross-entropy.  Each layer is recomputed in the backward
(``torch.utils.checkpoint``) so that a 4096-token sequence fits.

``precision="fp8"`` is the control: every matrix product (the linear
layers, the scores, the values, the head) takes its operands rounded
through float8 e4m3 with one scale a tensor (its largest magnitude to
448), the gradient passing straight through the rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = FP8_MAX / amax
    y = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (y - x.detach())


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def rope_tables(seq: int, hd: int, theta: float, device):
    """cos, sin [S, 1, hd/2] in float32, from float64 angles."""
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=device) / half)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * freqs
    return (torch.cos(ang).float()[:, None, :],
            torch.sin(ang).float()[:, None, :])


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _layer(x, cos, sin, w: dict, dm, rnd):
    S = x.shape[0]
    H, KV, hd = dm.heads, dm.kv, dm.hd

    def lin(t, name):
        y = rnd(t) @ rnd(w[name + "/w"])
        b = w.get(name + "/b")
        return y if b is None else y + b

    h = _rms(x, w["ln1/scale"], dm.eps)
    q = _rope(lin(h, "attn/q").view(S, H, hd), cos, sin)
    k = _rope(lin(h, "attn/k").view(S, KV, hd), cos, sin)
    v = lin(h, "attn/v").view(S, KV, hd)
    g = H // KV
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("shd,thd->hst", rnd(q), rnd(k)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = torch.einsum("hst,thd->shd", rnd(p), rnd(v)).reshape(S, H * hd)
    x = x + lin(o, "attn/o")
    h = _rms(x, w["ln2/scale"], dm.eps)
    return x + lin(F.silu(lin(h, "ffn/gate")) * lin(h, "ffn/up"), "ffn/down")


def row_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor, dm,
             precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence ``tokens`` / ``labels``
    [S] under ``params`` ({leaf name: float32 tensor}, the port's names:
    ``embed/table``, ``layers/<i>/...``, ``ln_f/scale``, ``lm_head/w``)."""
    rnd = {"f32": _same, "fp8": _fp8}[precision]
    S = tokens.shape[0]
    cos, sin = rope_tables(S, dm.hd, dm.theta, tokens.device)
    x = params["embed/table"][tokens]
    for i in range(dm.layers):
        pre = f"layers/{i}/"
        w = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        x = checkpoint(_layer, x, cos, sin, w, dm, rnd, use_reentrant=False,
                       preserve_rng_state=False)
    h = _rms(x, params["ln_f/scale"], dm.eps)
    logits = rnd(h) @ rnd(params["lm_head/w"])
    if logits.shape[-1] > dm.vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= dm.vocab
        logits = logits.masked_fill(pad, float("-inf"))
    return F.cross_entropy(logits, labels)
