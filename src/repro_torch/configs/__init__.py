"""Architectures the PyTorch port runs: ``get_config(name)``.

The dense GQA decoders ``qwen2-0.5b``, ``qwen2.5-3b`` and
``phi4-mini-3.8b``, the attention-free SSD ``mamba2-370m``, the hybrid
``zamba2-1.2b`` (Mamba2 layers with one shared attention block), the MoE
decoders ``olmoe-1b-7b`` and ``phi3.5-moe-42b-a6.6b``, the encoder-decoder
``whisper-medium``, the VLM backbone ``pixtral-12b`` and ``minicpm3-4b``
(a dense decoder with MLA, multi-head latent attention): the reference's
whole zoo.  ``INPUT_SHAPES`` is the reference's table of the input shapes
assigned to the paper."""
from repro_torch.configs import (mamba2_370m, minicpm3_4b, olmoe_1b_7b,
                                 phi3_5_moe, phi4_mini, pixtral_12b,
                                 qwen2_0_5b, qwen2_5_3b, whisper_medium,
                                 zamba2_1_2b)

CONFIGS = {c.name: c for c in (qwen2_0_5b.CONFIG, mamba2_370m.CONFIG,
                               qwen2_5_3b.CONFIG, phi4_mini.CONFIG,
                               zamba2_1_2b.CONFIG, olmoe_1b_7b.CONFIG,
                               phi3_5_moe.CONFIG, whisper_medium.CONFIG,
                               pixtral_12b.CONFIG, minicpm3_4b.CONFIG)}
ALL_ARCHS = list(CONFIGS)

# input shapes assigned to this paper
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}


def get_config(name: str):
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}' for the PyTorch port; known: "
                       f"{ALL_ARCHS}")
    return CONFIGS[name]
