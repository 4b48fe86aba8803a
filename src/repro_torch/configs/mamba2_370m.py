"""Mamba2-370m: attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", kind="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    head_dim=64,
    source="arXiv:2405.21060",
)
