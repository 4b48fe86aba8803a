"""Architectures the PyTorch port runs: ``get_config(name)``.

``qwen2-0.5b`` (dense GQA) and ``mamba2-370m`` (attention-free SSD) so far;
the rest of the reference's zoo is ROADMAP queue 1, item 9."""
from repro_torch.configs import mamba2_370m, qwen2_0_5b

CONFIGS = {c.name: c for c in (qwen2_0_5b.CONFIG, mamba2_370m.CONFIG)}
ALL_ARCHS = list(CONFIGS)


def get_config(name: str):
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}' for the PyTorch port; known: "
                       f"{ALL_ARCHS} (the rest of the zoo is ROADMAP queue "
                       f"1, item 9)")
    return CONFIGS[name]
