"""Phi-3.5-MoE (42B total / 6.6B active): 16-expert top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", kind="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=6400, vocab=32064, n_experts=16, top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
