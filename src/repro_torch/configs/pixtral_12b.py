"""Pixtral-12B language backbone (mistral-nemo style); the pixtral-ViT
vision tower and projector are stubs: batches carry patch embeddings
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", kind="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=160,
    d_ff=14336, vocab=131072, n_patches=256, rope_theta=1e7,
    source="hf:mistralai/Pixtral-12B-2409",
)
