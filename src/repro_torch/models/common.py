"""Architecture config and shard context of the PyTorch port.

Own copy of ``repro.models.common.ArchConfig`` (the dense-decoder, MoE,
Mamba2, hybrid, encoder-decoder, VLM and MLA fields the port runs):
``dtype`` is a torch dtype, ``reduced()`` gives the same smoke-test shapes
as the reference, and ``vocab_padded`` rounds the vocab up to a fixed
multiple of ``VOCAB_PAD`` that does not depend on the mesh.

:class:`ShardCtx` is the reference's shard context (``make_ctx``,
``validate_tp``) over the model axis of a ``(pod, data, model)`` mesh.
The reference runs one SPMD program per device under ``shard_map``; the
port runs one process per rank, and the model axis is a
``torch.distributed`` group of the M ranks that share a data index
(``launch/mesh.py``).  The model-axis collectives are
``torch.autograd.Function``s placed as Megatron-LM places them, so that
every leaf's gradient is its share of the TRUE gradient, the port's M = 1
gradient (DESIGN.md §9: a mesh moves bytes, never the function):

* ``copy_tp``: identity forward, all-reduce backward, where a replicated
  activation (or weight) enters computation that differs across the
  model ranks (a column-parallel matmul, a slice of the heads or tokens);
  every rank then holds the complete gradient of what it copied;
* ``psum_tp``: all-reduce forward, identity backward, at a row-parallel
  exit and at the vocab-sharded reductions whose sum is used alike on
  every rank;
* ``pmax_tp``: a constant under differentiation (a stability shift);
* ``all_to_all_tp``: its backward is the reverse all-to-all;
* ``all_gather_tp``: tiled along dim 0 into a replicated tensor; its
  backward takes this rank's slice of the (complete, replicated)
  cotangent, with no sum.

The reference's collectives under ``shard_map(check_vma=False)`` give
model-replicated gradients M times the true one (ROADMAP queue 3); the
port does not copy that.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

VOCAB_PAD = 128


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (exact sizes from the reference's config)."""

    name: str
    kind: str                  # dense | moe | ssm | hybrid | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # --- hybrid (zamba2-style shared attention block) ---
    shared_attn_every: int = 0     # apply shared attn block every k ssm layers
    # --- MLA (minicpm3) ---
    mla_q_rank: int = 0            # 0 -> standard GQA
    mla_kv_rank: int = 0
    mla_rope_dim: int = 32
    mla_v_dim: int = 64
    # --- enc-dec (whisper backbone) ---
    n_enc_layers: int = 0
    enc_len: int = 1500            # encoder frames (stub embeddings)
    # --- vlm ---
    n_patches: int = 0             # patch-embedding prefix length (stub)
    # --- long-context: decode attends to this window above 65536 tokens ---
    sliding_window: int = 4096
    dtype: torch.dtype = torch.bfloat16
    source: str = ""           # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attn_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, VOCAB_PAD)

    def n_params(self) -> int:
        """The reference's approximate parameter count (its roofline's
        MODEL_FLOPS): the unpadded embedding, per layer the attention
        projections (MLA's five), the SwiGLU or every expert's and the
        router, a Mamba2 mixer; an encoder-decoder's encoder layers and
        cross-attention, a hybrid's Mamba2 layers and one shared block.
        No norm, bias or LM head counts, as in the reference."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        din = self.d_inner
        ssm_per = (d * (2 * din + 2 * self.ssm_heads + 2 * self.ssm_state)
                   + din * d + din * self.ssm_conv)
        if self.kind == "ssm":
            return emb + L * ssm_per
        attn = (d * (self.n_heads * self.hd) * 2
                + d * (self.n_kv * self.hd) * 2)
        if self.mla_q_rank:
            attn = (d * self.mla_q_rank
                    + self.mla_q_rank * self.n_heads
                    * (self.hd + self.mla_rope_dim)
                    + d * (self.mla_kv_rank + self.mla_rope_dim)
                    + self.mla_kv_rank * self.n_heads
                    * (self.hd + self.mla_v_dim)
                    + self.n_heads * self.mla_v_dim * d)
        if self.kind == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        total = emb + L * (attn + ffn)
        if self.kind == "enc_dec":
            total += self.n_enc_layers * (attn + ffn) + L * attn
        if self.kind == "hybrid":
            total = emb + L * ssm_per + (attn + ffn)
        return total

    def n_active_params(self) -> int:
        """Parameters a token uses (the reference's): an MoE model's top_k
        of its n_experts; every other kind's :meth:`n_params`."""
        if self.kind != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        attn = (d * (self.n_heads * self.hd) * 2
                + d * (self.n_kv * self.hd) * 2)
        ffn = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        return self.vocab * d + L * (attn + ffn)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant, the reference's shapes: 2 layers (and <= 2
        encoder layers), d_model 256, 4 heads of 64, d_ff 384, vocab 512,
        <= 4 experts and top-2, MLA ranks <= 64 / 32, <= 24 encoder frames,
        <= 8 patches, SSM state <= 16 in chunks of 16, a 128-token window,
        the shared attention block every layer."""
        return dataclasses.replace(
            self, n_layers=2, n_enc_layers=min(self.n_enc_layers, 2),
            d_model=256, n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=64, d_ff=384, vocab=512,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            mla_q_rank=min(self.mla_q_rank, 64),
            mla_kv_rank=min(self.mla_kv_rank, 32),
            enc_len=min(self.enc_len, 24), n_patches=min(self.n_patches, 8),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16, sliding_window=128,
            shared_attn_every=(min(self.shared_attn_every, 1)
                               or self.shared_attn_every))


# ---------------------------------------------------------------------------
# Shard context and the model-axis collectives
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce (sum) of the gradient backward."""

    @staticmethod
    def forward(fctx, x, pg):
        fctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=fctx.pg)
        return g, None


class _Psum(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(fctx, x, pg):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(fctx, g):
        return g, None


def _all_to_all(x: torch.Tensor, pg) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=pg)
    return out


class _AllToAll(torch.autograd.Function):
    """[tp, ...] -> [tp, ...]: block j goes to rank j, the blocks arrive
    in source-rank order; the backward is the same exchange reversed."""

    @staticmethod
    def forward(fctx, x, pg):
        fctx.pg = pg
        return _all_to_all(x, pg)

    @staticmethod
    def backward(fctx, g):
        return _all_to_all(g, fctx.pg), None


# all_gather into one tensor; older torch names it all_gather_into_tensor
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


class _AllGather(torch.autograd.Function):
    """[n, ...] -> [tp * n, ...] in rank order; the backward takes this
    rank's n rows of the replicated output's cotangent."""

    @staticmethod
    def forward(fctx, x, pg, tp, rank):
        fctx.rows = (rank * x.shape[0], x.shape[0])
        x = x.contiguous()
        out = x.new_empty((tp * x.shape[0], *x.shape[1:]))
        _all_gather_single(out, x, group=pg)
        return out

    @staticmethod
    def backward(fctx, g):
        return g.narrow(0, *fctx.rows), None, None, None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The reference's ``ShardCtx``: the mesh's sizes and the per-family
    sharding decisions, fixed at build time, and the model group.

    ``tp`` model ranks (``group``: a ``core.schemes.DistGroup`` over them,
    None at tp = 1), ``dp`` data ranks in each of ``pods`` pods,
    ``node_size`` data ranks a node; ``shard_heads``: the q heads are
    sharded over the model axis (else replicated); ``decode_seq_shard``:
    the decode cache is sequence-sharded round-robin; ``h_pad``: the
    padded head count (``pad_heads``, 0 = none); ``moe_a2a``: the
    token-sharded MoE dispatch.  At tp = 1 every collective is the
    identity."""

    tp: int = 1
    dp: int = 1
    pods: int = 1
    node_size: int = 1
    shard_heads: bool = True
    decode_seq_shard: bool = True
    h_pad: int = 0
    moe_a2a: bool = False
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.tp > 1 and self.group is None:
            raise ValueError(f"tp={self.tp} needs the model group")

    @property
    def pg(self):
        return self.group.pg

    def tp_rank(self) -> int:
        return self.group.ranks[0] if self.tp > 1 else 0

    def copy_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.pg) if self.tp > 1 else x

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _Psum.apply(x, self.pg) if self.tp > 1 else x

    def pmean_tp(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum_tp(x) / self.tp if self.tp > 1 else x

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-rank max, a constant under differentiation."""
        if self.tp == 1:
            return x.detach()
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.pg)
        return out

    def all_to_all_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _AllToAll.apply(x, self.pg) if self.tp > 1 else x

    def all_gather_tp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        return _AllGather.apply(x, self.pg, self.tp, self.tp_rank())

    def shard(self, x: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's equal slice of ``x`` along ``dim`` (None or tp = 1:
        ``x`` itself)."""
        if dim is None or self.tp == 1:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.tp_rank() * n, n)

    def mean_tp(self, vals: dict) -> dict:
        """``{name: scalar}`` -> f32 means over the model group (one
        all-reduce; the same on every rank)."""
        if self.tp == 1 or not vals:
            return vals
        out = torch.stack([v.float() for v in vals.values()])
        dist.all_reduce(out, group=self.pg)
        return dict(zip(vals, (out / self.tp).unbind()))


def _require(cond: bool, cfg: ArchConfig, why: str) -> None:
    if not cond:
        raise ValueError(f"config '{cfg.name}': {why}")


def validate_tp(cfg: ArchConfig, tp: int, *, shard_heads: bool,
                h_pad: int) -> None:
    """The reference's eager divisibility checks for a tensor-parallel
    degree, with its errors naming the config."""
    if tp <= 1:
        return
    vp = cfg.vocab_padded
    _require(vp % tp == 0, cfg,
             f"padded vocab {vp} (vocab {cfg.vocab} padded to a fixed "
             f"multiple of {VOCAB_PAD}, mesh-invariant) is not divisible "
             f"by tp={tp}; pick a tp dividing {vp}")
    uses_mlp = (cfg.kind in ("dense", "enc_dec", "vlm", "hybrid")
                or bool(cfg.mla_q_rank))
    if uses_mlp:
        _require(cfg.d_ff % tp == 0, cfg,
                 f"d_ff={cfg.d_ff} is not divisible by tp={tp} "
                 f"(MLP is column->row parallel over the model axis)")
    if cfg.kind == "moe":
        _require(cfg.n_experts % tp == 0, cfg,
                 f"n_experts={cfg.n_experts} is not divisible by tp={tp} "
                 f"(experts are sharded over the model axis)")
    if cfg.kind in ("ssm", "hybrid"):
        _require(cfg.d_inner % tp == 0, cfg,
                 f"d_inner={cfg.d_inner} is not divisible by tp={tp}")
        _require(cfg.ssm_heads % tp == 0, cfg,
                 f"ssm_heads={cfg.ssm_heads} is not divisible by tp={tp}")
    # GQA head/KV nesting (MLA broadcasts k_rope per-head instead of
    # slicing replicated KV heads, so the nesting constraint is GQA-only)
    if (shard_heads and cfg.n_heads and not cfg.is_attn_free
            and not cfg.mla_q_rank):
        H = h_pad or cfg.n_heads
        _require(H % cfg.n_kv == 0, cfg,
                 f"n_heads={H} is not a multiple of n_kv={cfg.n_kv}")
        Hl, g = H // tp, H // cfg.n_kv
        _require(Hl % g == 0 or g % Hl == 0, cfg,
                 f"local q-heads {Hl} and GQA group {g} do not nest at "
                 f"tp={tp} (need Hl % g == 0 or g % Hl == 0 for the "
                 f"replicated-KV slice)")


def make_ctx(cfg: ArchConfig, tp: int = 1, dp: int = 1, pods: int = 1,
             pad_heads: bool = False, moe_a2a: bool = False,
             node_size: int = 1, group=None) -> ShardCtx:
    """The reference's ``make_ctx``: the q heads shard over the model axis
    when ``n_heads % tp == 0``, or, with ``pad_heads``, after padding them
    to a multiple of tp (``h_pad``); ``group`` is the model group."""
    h_pad = 0
    shard = cfg.n_heads % tp == 0
    if pad_heads and not shard and cfg.n_heads > 0:
        h_pad = pad_to(cfg.n_heads, tp)
        shard = True
    validate_tp(cfg, tp, shard_heads=shard, h_pad=h_pad)
    if node_size > 1:
        _require(dp % node_size == 0, cfg,
                 f"node_size={node_size} does not divide the data-parallel "
                 f"degree dp={dp}; pick a node size dividing {dp} (or 1 "
                 f"for the flat topology)")
    return ShardCtx(tp=tp, dp=dp, pods=pods, node_size=max(node_size, 1),
                    shard_heads=shard, h_pad=h_pad, moe_a2a=moe_a2a,
                    group=group if tp > 1 else None)


# leaf name -> its model-sharded dim, per parent module (the reference's
# PartitionSpecs: ``init_linear``'s modes, ``init_moe``, ``init_mamba2``)
_HEAD_DIMS = {"q_w": 1, "q_b": 0, "o_w": 0, "q_up_w": 1, "kv_up_w": 1}
_FFN_DIMS = {"gate_w": 1, "up_w": 1, "up_b": 0, "down_w": 0, "w_gate": 0,
             "w_up": 0, "w_down": 0}
_MIXER_DIMS = {"in_z_w": 1, "in_x_w": 1, "in_dt_w": 1, "out_w": 0,
               "conv_w": 1, "conv_b": 0, "A_log": 0, "dt_bias": 0, "D": 0,
               "norm": 0}


def tp_dim(path: tuple, ctx: ShardCtx) -> int | None:
    """The model-sharded dim of the reference leaf at ``path`` (its keys,
    without the stacked layer dims), or None for a replicated leaf."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if path == ("embed", "table"):
        return 0
    if name == "lm_head_w":
        return 1
    if parent in ("attn", "xattn"):
        return _HEAD_DIMS.get(name) if ctx.shard_heads else None
    if parent == "ffn":
        return _FFN_DIMS.get(name)
    if parent == "mixer":
        return _MIXER_DIMS.get(name)
    return None
