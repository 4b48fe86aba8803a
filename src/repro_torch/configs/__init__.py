"""Architectures the PyTorch port runs: ``get_config(name)``.

The dense GQA decoders ``qwen2-0.5b``, ``qwen2.5-3b`` and
``phi4-mini-3.8b`` and the attention-free SSD ``mamba2-370m``; the rest of
the reference's zoo (zamba2, the MoE models, whisper, pixtral, minicpm3) is
ROADMAP queue 1, item 9."""
from repro_torch.configs import mamba2_370m, phi4_mini, qwen2_0_5b, qwen2_5_3b

CONFIGS = {c.name: c for c in (qwen2_0_5b.CONFIG, mamba2_370m.CONFIG,
                               qwen2_5_3b.CONFIG, phi4_mini.CONFIG)}
ALL_ARCHS = list(CONFIGS)


def get_config(name: str):
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}' for the PyTorch port; known: "
                       f"{ALL_ARCHS} (zamba2, the MoE models, whisper, "
                       f"pixtral and minicpm3 are ROADMAP queue 1, item 9)")
    return CONFIGS[name]
