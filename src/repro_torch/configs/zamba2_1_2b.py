"""Zamba2-1.2B: Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", kind="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=8192, vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
