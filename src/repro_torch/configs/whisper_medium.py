"""Whisper-medium transformer backbone (enc-dec); the conv/mel frontend is
a stub: batches carry precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", kind="enc_dec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    head_dim=64, d_ff=4096, vocab=51865, qkv_bias=True, enc_len=1500,
    source="arXiv:2212.04356",
)
