"""Qwen2.5-3B: dense GQA (kv=2), QKV bias [hf:Qwen/Qwen2.5-3B]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", kind="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 3B sizes)",
)
