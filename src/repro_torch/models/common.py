"""Architecture config of the PyTorch port.

Own copy of ``repro.models.common.ArchConfig`` (the dense-decoder, MoE,
Mamba2, hybrid, encoder-decoder, VLM and MLA fields the port runs):
``dtype`` is a torch dtype, ``reduced()`` gives the same smoke-test shapes
as the reference, and ``vocab_padded`` rounds the vocab up to a fixed
multiple of ``VOCAB_PAD`` that does not depend on the mesh.
"""
from __future__ import annotations

import dataclasses

import torch

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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, VOCAB_PAD)

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
