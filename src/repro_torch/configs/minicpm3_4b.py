"""MiniCPM3-4B: MLA (multi-head latent attention), 62 layers
[hf:openbmb/MiniCPM3-4B]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", kind="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv=40, head_dim=64,
    d_ff=6400, vocab=73448,
    mla_q_rank=768, mla_kv_rank=256, mla_rope_dim=32, mla_v_dim=64,
    source="hf:openbmb/MiniCPM3-4B",
)
