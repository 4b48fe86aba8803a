"""Mixture-of-Experts FFN (port of ``repro.models.moe``: ``init_moe``,
``moe_ffn``, ``moe_ffn_replicated`` and ``moe_ffn_a2a``).

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

Under tensor parallelism the experts are sharded over the model axis:
rank r holds experts ``[r El, (r + 1) El)``, ``El = E / tp``.  Two
dispatches, as the reference's ``moe_ffn`` switch picks them:

* replicated (the default, and for a token count tp does not divide, as
  a decode step's ``T = B < tp``): every rank routes all T tokens, runs its
  El experts' queues and keeps their pairs' outputs; a psum over the
  model group adds the ranks' partial outputs;
* ``ctx.moe_a2a``: rank r routes its own ``T / tp`` tokens at a capacity
  taken from that slice, sends each expert's queue to its owner and gets
  the outputs back (two all-to-alls, the gates shipped beside the
  tokens), and an all-gather makes the output whole again; the stats are
  model means.  It equals the replicated dispatch when no pair is dropped
  (the capacities differ).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig, ShardCtx
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
    # dropped pairs go to a dump slot past the end, cut off (kept slots are
    # unique): the shapes do not depend on the data
    pair_of_slot = torch.full((E * cap + 1,), n, dtype=torch.long,
                              device=logits.device)
    pair_of_slot[torch.where(keep, slot, E * cap)] = ar
    pair_of_slot = pair_of_slot[:E * cap]
    return {"probs": probs, "gate": gate, "eidx": eidx, "keep": keep,
            "slot": slot, "pair_of_slot": pair_of_slot}


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` [n, ...] with one zero row appended (the target of the
    sentinel index ``n``)."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def expert_share(eidx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """f_e [E] f32: the pairs routed to expert e over the T tokens of
    ``eidx`` [T, K] (each of a token's K choices counts once)."""
    flat = eidx.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat.device)
    # a scatter-add into E bins: bincount's length depends on the data
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.float() / eidx.shape[0]


def moe_stats(r: dict, n_experts: int, mean=lambda x: x) -> dict:
    """The reference's router statistics: the Switch-style load-balance
    loss ``E * sum_e f_e / K * p_e`` (p_e: the mean router probability of
    expert e), the share of dropped pairs and the router skew ``max f_e /
    mean f_e`` (:func:`expert_share`); ``mean`` averages f_e, p_e and the
    dropped share over the model group (the token-sharded dispatch)."""
    K = r["eidx"].shape[1]
    f_e = mean(expert_share(r["eidx"], n_experts))
    p_e = mean(r["probs"].mean(0))
    return {"moe/aux_loss": n_experts * (f_e / K * p_e).sum(),
            "moe/dropped": mean(1.0 - r["keep"].float().mean()),
            "moe/skew": f_e.max() / f_e.mean().clamp(min=1e-9)}


class MoE(nn.Module):
    """The reference's MoE FFN parameters (``init_moe``): ``router_w``
    [d, E] at scale 0.02 (replicated), ``w_gate`` / ``w_up`` [E, d, f] at
    1/sqrt(d) and ``w_down`` [E, f, d] at 1/sqrt(f), in the model's
    dtype, this rank's El experts of each."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=cfg.dtype, device=device)
        self.router_w = nn.Parameter(_normal(gen, (d, E), 0.02, **kw))
        for name, shape, fan_in in (("w_gate", (E, d, f), d),
                                    ("w_up", (E, d, f), d),
                                    ("w_down", (E, f, d), f)):
            w = _normal(gen, shape, 1 / math.sqrt(fan_in), **kw)
            setattr(self, name, nn.Parameter(ctx.shard(w, 0).clone()))

    def _experts(self, xin: torch.Tensor, gates: torch.Tensor):
        """This rank's experts on their queues xin [El, n, d], each output
        row scaled by its gate [El, n]."""
        h = F.silu(xin @ self.w_gate) * (xin @ self.w_up)
        return (h @ self.w_down) * gates[..., None].to(h.dtype)

    def forward(self, x: torch.Tensor):
        """x [B, S, d] -> (y [B, S, d] in x's dtype, stats: ``moe/aux_loss``,
        ``moe/dropped``, ``moe/skew``, f32 scalars): the reference's
        ``moe_ffn`` switch."""
        T = x.shape[0] * x.shape[1]
        ctx = self.ctx
        if ctx.moe_a2a and ctx.tp > 1 and T % ctx.tp == 0:
            return self._a2a(x)
        return self._replicated(x)

    def _replicated(self, x: torch.Tensor):
        """Every rank routes all T tokens; its El experts take their slots
        of the [E, cap] dispatch; a model psum adds the ranks' outputs."""
        cfg, ctx = self.cfg, self.ctx
        Bt, S, d = x.shape
        E, K, T = cfg.n_experts, cfg.top_k, Bt * S
        El, lo = E // ctx.tp, ctx.tp_rank() * (E // ctx.tp)
        cap = capacity(T, cfg)
        xf = x.reshape(T, d)
        # router logits in the model dtype, then f32
        r = route((xf @ self.router_w.to(xf.dtype)).float(), K, cap)
        pos = r["pair_of_slot"][lo * cap:(lo + El) * cap]
        xrep = ctx.copy_tp(xf)[:, None].expand(T, K, d).reshape(T * K, d)
        xin = _pad_row(xrep)[pos].view(El, cap, d)  # empty slots: zeros
        g_slot = _pad_row(ctx.copy_tp(r["gate"]).reshape(-1))[pos]
        yex = self._experts(xin, g_slot.view(El, cap))
        # each pair reads its slot's output; a dropped pair, or one another
        # rank's experts hold, the zero row
        local = r["slot"] - lo * cap
        mine = r["keep"] & (local >= 0) & (local < El * cap)
        take = torch.where(mine, local, El * cap)
        y = _pad_row(yex.reshape(El * cap, d))[take].view(T, K, d).sum(1)
        y = ctx.psum_tp(y)
        return y.reshape(Bt, S, d).to(x.dtype), moe_stats(r, E)

    def _a2a(self, x: torch.Tensor):
        """The token-sharded dispatch (the reference's ``moe_ffn_a2a``):
        rank r routes tokens ``[r Tl, (r + 1) Tl)`` at the capacity of Tl
        tokens, ships each expert's queue (and its gates) to the expert's
        owner, gets the outputs back and combines its tokens; the output
        is all-gathered."""
        cfg, ctx = self.cfg, self.ctx
        Bt, S, d = x.shape
        E, K, tp = cfg.n_experts, cfg.top_k, ctx.tp
        El, Tl = E // tp, Bt * S // tp
        cap = capacity(Tl, cfg)
        r0 = ctx.tp_rank() * Tl
        xl = ctx.copy_tp(x.reshape(Bt * S, d))[r0:r0 + Tl]
        router = ctx.copy_tp(self.router_w)   # used on this rank's tokens
        r = route((xl @ router.to(xl.dtype)).float(), K, cap)
        pos = r["pair_of_slot"]
        xrep = xl[:, None].expand(Tl, K, d).reshape(Tl * K, d)
        xin = _pad_row(xrep)[pos]                           # [E * cap, d]
        g_slot = _pad_row(r["gate"].reshape(-1))[pos]       # [E * cap]
        # queues of expert e go to rank e // El; rows arrive by source rank
        recv = ctx.all_to_all_tp(xin.view(tp, El * cap, d))
        g_recv = ctx.all_to_all_tp(g_slot.view(tp, El * cap))
        xin_e = recv.view(tp, El, cap, d).transpose(0, 1).reshape(
            El, tp * cap, d)
        g_e = g_recv.view(tp, El, cap).transpose(0, 1).reshape(El, tp * cap)
        yex = self._experts(xin_e, g_e)
        back = yex.view(El, tp, cap, d).transpose(0, 1).reshape(
            tp, El * cap, d)
        got = ctx.all_to_all_tp(back).view(E * cap, d)   # by expert, slot
        take = torch.where(r["keep"], r["slot"], E * cap)
        y = _pad_row(got)[take].view(Tl, K, d).sum(1)
        y = ctx.all_gather_tp(y)
        return (y.reshape(Bt, S, d).to(x.dtype),
                moe_stats(r, E, mean=ctx.pmean_tp))
