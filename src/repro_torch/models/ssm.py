"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block (port of
``repro.models.ssm``).

Prefill and training run the chunked block decomposition
(:func:`_ssd_chunked`) on the ``ssd_fwd`` kernel; training takes it under
autograd (``ops.SSDScan``: the kernel forward, the plain scan's gradient
backward, as the reference trains by autodiff through its plain scan).
Decode is the O(1) recurrence on the [B, H, hd, N] state and stays plain
PyTorch (the reference has no kernel there).  B and C are shared by all
heads (ngroups = 1).

Tensor parallelism (``ctx``, tp > 1; the reference's ``init_mamba2``):
the SSM heads and d_inner are sharded over the model axis.  ``in_z``,
``in_x`` and ``in_dt`` are column-parallel, ``out`` row-parallel; the
depthwise ``conv_w`` / ``conv_b``, the per-head ``A_log``, ``dt_bias``
and ``D`` and the gated norm's ``norm`` hold this rank's slice, and the
gated norm's variance is summed over the model group
(``layers.rmsnorm_sharded``).  ``in_bc`` (B and C, shared by every head)
is replicated; its output feeds this rank's heads only, so it enters
them through ``copy_tp`` and its gradient is summed over the model
group.  The scan runs on this rank's ``H / tp`` heads, and the decode
cache holds their state and this rank's ``d_inner / tp`` conv columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.hashing import check_backend
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_fwd_ref
from repro_torch.models.common import ArchConfig, ShardCtx
from repro_torch.models.layers import Linear, _normal, rmsnorm_sharded


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B, S, C], w [K, C] -> [B, S, C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, k:k + S, :] * w[k] for k in range(K))
    return y + bias


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 chunk: int, *, backend: str = "cuda"):
    """Chunked SSD scan.

    xh [Bt, S, H, hd]; dt [Bt, S, H] (post-softplus); a_log [H]
    (A = -exp(a_log)); Bm, Cm [Bt, S, N]; D [H].  S is zero-padded to a
    multiple of the chunk (padded steps are the identity: dt = 0 gives
    decay 1 and input 0).  Returns y [Bt, S, H, hd] and the final state
    [Bt, H, hd, N], f32.  ``backend="cuda"`` scans through
    ``ops.ssd_fwd_op`` (the kernel for CUDA tensors, the plain version for
    CPU ones), under autograd as ``ops.SSDScan`` whenever grad is enabled;
    ``"torch"`` scans through the plain version (autograd through it)."""
    check_backend(backend)
    S = xh.shape[1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xp, dtp, bp, cp = xh, dt, Bm, Cm
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        bp = F.pad(Bm, (0, 0, 0, pad))
        cp = F.pad(Cm, (0, 0, 0, pad))
    A = -torch.exp(a_log)
    dA = (dtp * A).contiguous()                       # log-decay
    xdt = (xp * dtp[..., None]).contiguous()          # input scaled by dt
    args = (xdt, dA, bp.contiguous(), cp.contiguous())
    if backend != "cuda":
        y, state = ssd_fwd_ref(*args, chunk=Q)
    elif torch.is_grad_enabled():
        y, state = ops.SSDScan.apply(*args, Q)
    else:
        y, state = ops.ssd_fwd_op(*args, chunk=Q)
    return y[:, :S] + xh * D[:, None], state


class Mamba2(nn.Module):
    """One Mamba2 mixer: the reference's parameters (``init_mamba2``),
    this rank's shards under tensor parallelism."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None,
                 ctx: ShardCtx = ShardCtx()):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        self.heads = H // ctx.tp
        kw = dict(dtype=cfg.dtype, device=device, gen=gen, ctx=ctx)
        self.in_z = Linear(d, din, mode="col", **kw)
        self.in_x = Linear(d, din, mode="col", **kw)
        self.in_dt = Linear(d, H, mode="col", **kw)
        self.in_bc = Linear(d, 2 * N, **kw)          # shared B, C
        self.out = Linear(din, d, mode="row", **kw)

        def mine(t: torch.Tensor, dim: int = 0) -> nn.Parameter:
            return nn.Parameter(ctx.shard(t, dim).clone())

        self.conv_w = mine(_normal(gen, (cfg.ssm_conv, din), 0.5, cfg.dtype,
                                   device), 1)
        self.conv_b = mine(torch.zeros(din, dtype=cfg.dtype, device=device))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = mine(torch.zeros(H, **f32))
        self.dt_bias = mine(torch.zeros(H, **f32))
        self.D = mine(torch.zeros(H, **f32))
        self.norm = mine(torch.ones(din, **f32))

    def _dt_bc(self, xc: torch.Tensor, x: torch.Tensor):
        """dt (softplus, f32) [..., H / tp] of ``xc`` (x through
        ``copy_tp``) and B, C (f32) [..., N] of x, entering this rank's
        heads through ``copy_tp``."""
        N = self.cfg.ssm_state
        dt = F.softplus(self.in_dt(xc).float() + self.dt_bias)
        bc = self.ctx.copy_tp(self.in_bc(x)).float()
        return dt, bc[..., :N], bc[..., N:]

    def _gate_out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.out(rmsnorm_sharded(self.norm, y * F.silu(z),
                                        ctx=self.ctx))

    def forward(self, x: torch.Tensor, *, return_cache: bool = False,
                backend: str = "cuda"):
        """Full sequence x [B, S, d] -> [B, S, d] (``mamba2_train``);
        ``return_cache=True`` also returns the decode cache (final SSD
        state and the conv tail), so prefill hands off to decode exactly."""
        cfg = self.cfg
        Bt, S, _ = x.shape
        xc = self.ctx.copy_tp(x)
        z = self.in_z(xc)
        xs_raw = self.in_x(xc)
        xs = F.silu(_causal_conv(xs_raw, self.conv_w, self.conv_b))
        dt, Bm, Cm = self._dt_bc(xc, x)
        xh = xs.reshape(Bt, S, self.heads, cfg.ssm_head_dim).float()
        y, state = _ssd_chunked(xh, dt, self.A_log, Bm, Cm, self.D,
                                cfg.ssm_chunk, backend=backend)
        out = self._gate_out(y.reshape(Bt, S, -1).to(x.dtype), z)
        if not return_cache:
            return out
        K = cfg.ssm_conv   # the last K-1 raw inputs (zeros before t = 0)
        conv = F.pad(xs_raw, (0, 0, K - 1, 0))[:, S:]
        return out, {"state": state, "conv": conv}

    def make_cache(self, batch: int) -> dict:
        """Empty decode cache: state [batch, H / tp, hd, N] f32 and the
        conv tail [batch, K-1, d_inner / tp] in the model's dtype, zeros."""
        cfg, dev = self.cfg, self.norm.device
        return {"state": torch.zeros((batch, self.heads, cfg.ssm_head_dim,
                                      cfg.ssm_state), dtype=torch.float32,
                                     device=dev),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                     self.norm.shape[0]),
                                    dtype=cfg.dtype, device=dev)}

    def decode(self, x: torch.Tensor, cache: dict):
        """One-token recurrence x [B, d] -> ([B, d], new cache)."""
        cfg = self.cfg
        Bt = x.shape[0]
        xc = self.ctx.copy_tp(x)
        z = self.in_z(xc)
        conv_in = torch.cat([cache["conv"], self.in_x(xc)[:, None]], dim=1)
        xs = F.silu(torch.einsum("bkc,kc->bc", conv_in, self.conv_w)
                    + self.conv_b)
        dt, Bm, Cm = self._dt_bc(xc, x)
        xh = xs.reshape(Bt, self.heads, cfg.ssm_head_dim).float()
        decay = torch.exp(dt * -torch.exp(self.A_log))            # [B, H]
        state = (cache["state"] * decay[..., None, None]
                 + torch.einsum("bhd,bn,bh->bhdn", xh, Bm, dt))
        y = torch.einsum("bn,bhdn->bhd", Cm, state) + xh * self.D[:, None]
        out = self._gate_out(y.reshape(Bt, -1).to(x.dtype), z)
        return out, {"state": state, "conv": conv_in[:, 1:]}
