"""Architecture config of the PyTorch port.

Own copy of ``repro.models.common.ArchConfig`` (the dense-decoder and
Mamba2 fields the port runs): ``dtype`` is a torch dtype, ``reduced()``
gives the same smoke-test shapes as the reference, and ``vocab_padded``
rounds the vocab up to a fixed multiple of ``VOCAB_PAD`` that does not
depend on the mesh.
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
    kind: str                  # "dense" or "ssm" in the port so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64
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
        """Smoke-test variant, the reference's shapes: 2 layers,
        d_model 256, 4 heads of 64, d_ff 384, vocab 512, SSM state <= 16 in
        chunks of 16, a 128-token window."""
        return dataclasses.replace(
            self, n_layers=2, d_model=256, n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=64, d_ff=384, vocab=512,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16, sliding_window=128)
