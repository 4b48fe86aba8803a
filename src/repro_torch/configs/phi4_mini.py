"""Phi-4-mini 3.8B: dense RoPE SwiGLU GQA [arXiv:2412.08905]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", kind="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, head_dim=128,
    d_ff=8192, vocab=200064,
    source="arXiv:2412.08905",
)
