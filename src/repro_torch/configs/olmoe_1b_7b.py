"""OLMoE-1B-7B: 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", kind="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1024, vocab=50304, n_experts=64, top_k=8,
    source="arXiv:2409.02060",
)
