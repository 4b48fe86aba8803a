"""Architectures the PyTorch port runs: ``get_config(name)``.

The dense GQA decoders ``qwen2-0.5b``, ``qwen2.5-3b`` and
``phi4-mini-3.8b``, the attention-free SSD ``mamba2-370m``, the hybrid
``zamba2-1.2b`` (Mamba2 layers with one shared attention block) and the
MoE decoders ``olmoe-1b-7b`` and ``phi3.5-moe-42b-a6.6b``; the rest of the
reference's zoo (whisper, pixtral, minicpm3) is ROADMAP queue 1, item 9."""
from repro_torch.configs import (mamba2_370m, olmoe_1b_7b, phi3_5_moe,
                                 phi4_mini, qwen2_0_5b, qwen2_5_3b,
                                 zamba2_1_2b)

CONFIGS = {c.name: c for c in (qwen2_0_5b.CONFIG, mamba2_370m.CONFIG,
                               qwen2_5_3b.CONFIG, phi4_mini.CONFIG,
                               zamba2_1_2b.CONFIG, olmoe_1b_7b.CONFIG,
                               phi3_5_moe.CONFIG)}
ALL_ARCHS = list(CONFIGS)


def get_config(name: str):
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}' for the PyTorch port; known: "
                       f"{ALL_ARCHS} (whisper, pixtral and minicpm3 are "
                       f"ROADMAP queue 1, item 9)")
    return CONFIGS[name]
