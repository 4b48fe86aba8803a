"""Qwen2-0.5B: dense GQA (kv=2), QKV bias [arXiv:2407.10671]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", kind="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, head_dim=64,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)
