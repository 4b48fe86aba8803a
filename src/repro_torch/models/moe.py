"""Mixture-of-Experts FFN (port of ``repro.models.moe`` at tp = 1:
``init_moe`` and ``moe_ffn_replicated``).

Every token is routed to its top-K experts by an f32 softmax over the
router logits; each expert takes at most ``cap = ceil(T * K / E *
capacity_factor)`` (token, k) pairs of the flattened ``[B * S]`` token
axis, in token order, and drops the rest.  The expert SwiGLUs run batched
over the experts (``torch.matmul`` on ``[E, cap, d]`` queues); the
reference computes them outside any Pallas kernel too.

Dispatch and combine use only injective index maps: the reference's
scatter-add combine (``.at[tok].add``) would be CUDA atomics here, whose
order, and so whose bf16 sums, change from run to run.  Each (token, k)
pair instead gathers its queue slot's output (a dropped pair reads a zero
row) and the K outputs of a token are summed by a reduction; the queues
are gathered from the token rows repeated K times (an ``expand``, whose
backward is a sum), so every gradient scatter also has unique indices.
This equals the reference up to the order of a token's K adds.

``moe_ffn_a2a`` (the token-sharded all-to-all dispatch) exists only under
tensor parallelism, which the port does not run (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import _normal


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """An expert's queue length for ``tokens`` tokens (the reference's
    rule, over the whole flattened token axis)."""
    return max(1, int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def route(logits: torch.Tensor, top_k: int, cap: int) -> dict:
    """Top-K routing and queue slots from f32 router logits [T, E].

    Returns ``probs`` [T, E] (softmax), ``gate`` [T, K] (the top-K
    probabilities renormalised to sum to 1), ``eidx`` [T, K] (their
    experts, the lower index first on ties, as ``lax.top_k``), ``keep``
    [T * K] (a pair's place in its expert's queue, pairs in (token, k)
    order, is under ``cap``), ``slot`` [T * K] (``e * cap`` + that place)
    and ``pair_of_slot`` [E * cap] (the pair ``t * K + k`` each slot
    holds, ``T * K`` for an empty one: the reference's dispatch buffer
    holds token ``pair // K`` there, or its sentinel ``T``)."""
    E = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top.values[:, :top_k], top.indices[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True)
    flat_e = eidx.reshape(-1)
    n = flat_e.numel()
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    ar = torch.arange(n, device=logits.device)
    rank = torch.empty_like(flat_e)
    rank[order] = ar - torch.searchsorted(sorted_e, sorted_e)
    keep = rank < cap
    slot = flat_e * cap + rank
    pair_of_slot = torch.full((E * cap,), n, dtype=torch.long,
                              device=logits.device)
    pair_of_slot[slot[keep]] = ar[keep]
    return {"probs": probs, "gate": gate, "eidx": eidx, "keep": keep,
            "slot": slot, "pair_of_slot": pair_of_slot}


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, ...] with one zero row appended (the target of the
    sentinel index ``n``)."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def expert_share(eidx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """f_e [E] f32: the pairs routed to expert e over the T tokens of
    ``eidx`` [T, K] (each of a token's K choices counts once)."""
    return torch.bincount(eidx.reshape(-1),
                          minlength=n_experts).float() / eidx.shape[0]


def moe_stats(r: dict, n_experts: int) -> dict:
    """The reference's router statistics: the Switch-style load-balance
    loss ``E * sum_e f_e / K * p_e`` (p_e: the mean router probability of
    expert e), the share of dropped pairs and the router skew ``max f_e /
    mean f_e`` (:func:`expert_share`)."""
    K = r["eidx"].shape[1]
    f_e = expert_share(r["eidx"], n_experts)
    p_e = r["probs"].mean(0)
    return {"moe/aux_loss": n_experts * (f_e / K * p_e).sum(),
            "moe/dropped": 1.0 - r["keep"].float().mean(),
            "moe/skew": f_e.max() / f_e.mean().clamp(min=1e-9)}


class MoE(nn.Module):
    """The reference's MoE FFN parameters (``init_moe``): ``router_w``
    [d, E] at scale 0.02, ``w_gate`` / ``w_up`` [E, d, f] at 1/sqrt(d) and
    ``w_down`` [E, f, d] at 1/sqrt(f), in the model's dtype."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=cfg.dtype, device=device)
        self.router_w = nn.Parameter(_normal(gen, (d, E), 0.02, **kw))
        self.w_gate = nn.Parameter(_normal(gen, (E, d, f), 1 / math.sqrt(d),
                                           **kw))
        self.w_up = nn.Parameter(_normal(gen, (E, d, f), 1 / math.sqrt(d),
                                         **kw))
        self.w_down = nn.Parameter(_normal(gen, (E, f, d), 1 / math.sqrt(f),
                                           **kw))

    def forward(self, x: torch.Tensor):
        """x [B, S, d] -> (y [B, S, d] in x's dtype, stats: ``moe/aux_loss``,
        ``moe/dropped``, ``moe/skew``, f32 scalars)."""
        cfg = self.cfg
        Bt, S, d = x.shape
        E, K, T = cfg.n_experts, cfg.top_k, Bt * S
        cap = capacity(T, cfg)
        xf = x.reshape(T, d)
        # router logits in the model dtype, then f32
        r = route((xf @ self.router_w.to(xf.dtype)).float(), K, cap)
        pos = r["pair_of_slot"]
        xrep = xf[:, None].expand(T, K, d).reshape(T * K, d)
        xin = _pad_row(xrep)[pos].view(E, cap, d)   # empty slots: zeros
        g_slot = _pad_row(r["gate"].reshape(-1))[pos].view(E, cap)
        h = F.silu(xin @ self.w_gate) * (xin @ self.w_up)
        yex = (h @ self.w_down) * g_slot[..., None].to(h.dtype)
        # each pair reads its slot's output, a dropped pair the zero row
        take = torch.where(r["keep"], r["slot"], E * cap)
        y = _pad_row(yex.reshape(E * cap, d))[take].view(T, K, d).sum(1)
        return y.reshape(Bt, S, d).to(x.dtype), moe_stats(r, E)
