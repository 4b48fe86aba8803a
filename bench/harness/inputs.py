"""A cell's inputs from ``--seed``: the weights and the batches.

Both sides of the comparison get the same inputs: the program has them
copied into its parameters, the reference makes them again from the same
seed.  Weights are drawn on the device in two calls (one flat buffer per
storage dtype), batches one step at a time; the same seed and device give
the same values.

The leaf list is a dense decoder's in the port's naming and order (the
untied input embedding ``embed/table`` [Vp, d] with Vp the vocabulary
padded to a multiple of 128, its padding rows zero; per layer ``ln1``, the
attention's q / k / v / o, ``ln2``, the SwiGLU's gate / up / down;
``ln_f``; the head ``lm_head/w`` [d, Vp]), weights stored [d_in, d_out].
"""
from __future__ import annotations

import dataclasses
import math

import torch

MASK64 = (1 << 64) - 1
VOCAB_PAD = 128


def mix(*values: int) -> int:
    """A 63-bit seed from any whole numbers (splitmix64 over them)."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = (h ^ (int(v) & MASK64)) & MASK64
        h = (h + 0x9E3779B97F4A7C15) & MASK64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        h = z ^ (z >> 31)
    return h & 0x7FFFFFFFFFFFFFFF


def generator(device, *values: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(*values))
    return g


# salts that keep the weights' and the batches' streams apart
WEIGHTS, BATCH = 1, 2


@dataclasses.dataclass(frozen=True)
class Dims:
    """A dense decoder's sizes, read from a configuration file."""

    layers: int
    d: int
    heads: int
    kv: int
    hd: int
    ff: int
    vocab: int
    theta: float
    eps: float
    qkv_bias: bool

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // VOCAB_PAD) * VOCAB_PAD


def dims(config: dict) -> Dims:
    """The sizes of a configuration file (Hugging Face key names)."""
    heads = config["num_attention_heads"]
    return Dims(layers=config["num_hidden_layers"], d=config["hidden_size"],
                heads=heads, kv=config["num_key_value_heads"],
                hd=config.get("head_dim") or config["hidden_size"] // heads,
                ff=config["intermediate_size"], vocab=config["vocab_size"],
                theta=float(config["rope_theta"]),
                eps=float(config["rms_norm_eps"]),
                qkv_bias=bool(config["attention_bias"]))


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: torch.dtype
    scale: float       # normal * scale (+ 1 for a norm's scale)
    norm: bool = False

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def leaves(dm: Dims) -> list[Leaf]:
    """Every parameter of the decoder, in the port's order."""
    bf, f32 = torch.bfloat16, torch.float32
    d, q, kv = dm.d, dm.heads * dm.hd, dm.kv * dm.hd
    out = [Leaf("embed/table", (dm.vocab_padded, d), bf, 0.02)]
    for i in range(dm.layers):
        p = f"layers/{i}"
        out.append(Leaf(f"{p}/ln1/scale", (d,), f32, 0.05, norm=True))
        for name, width in (("q", q), ("k", kv), ("v", kv)):
            out.append(Leaf(f"{p}/attn/{name}/w", (d, width), bf,
                            1 / math.sqrt(d)))
            if dm.qkv_bias:
                out.append(Leaf(f"{p}/attn/{name}/b", (width,), bf, 0.02))
        out.append(Leaf(f"{p}/attn/o/w", (q, d), bf, 1 / math.sqrt(q)))
        out.append(Leaf(f"{p}/ln2/scale", (d,), f32, 0.05, norm=True))
        out.append(Leaf(f"{p}/ffn/gate/w", (d, dm.ff), bf, 1 / math.sqrt(d)))
        out.append(Leaf(f"{p}/ffn/up/w", (d, dm.ff), bf, 1 / math.sqrt(d)))
        out.append(Leaf(f"{p}/ffn/down/w", (dm.ff, d), bf,
                        1 / math.sqrt(dm.ff)))
    out.append(Leaf("ln_f/scale", (d,), f32, 0.05, norm=True))
    out.append(Leaf("lm_head/w", (d, dm.vocab_padded), bf, 1 / math.sqrt(d)))
    return out


@torch.no_grad()
def weights(dm: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """{leaf name: tensor} drawn from ``seed`` on ``device``: one normal
    draw per storage dtype, then each leaf's slice scaled in place (a
    norm's scale 1 + 0.05 n).  The vocabulary's padding rows of the
    embedding and columns of the head are zero."""
    ls = leaves(dm)
    gen = generator(device, seed, WEIGHTS)
    flat = {dt: torch.randn(sum(lf.numel for lf in ls if lf.dtype == dt),
                            generator=gen, dtype=dt, device=device)
            for dt in (torch.bfloat16, torch.float32)}
    off = dict.fromkeys(flat, 0)
    out = {}
    for lf in ls:
        o = off[lf.dtype]
        t = flat[lf.dtype][o:o + lf.numel].view(lf.shape)
        off[lf.dtype] = o + lf.numel
        t.mul_(lf.scale)
        if lf.norm:
            t.add_(1.0)
        out[lf.name] = t
    out["embed/table"][dm.vocab:] = 0
    out["lm_head/w"][:, dm.vocab:] = 0
    return out


class Batches:
    """The traffic's batches: ``tokens`` / ``labels`` int64 [global batch,
    seq] of step ``i``, token ids drawn from Zipf(``zipf``) over the
    vocabulary by the inverse of its distribution function, from
    (``seed``, ``i``) on ``device``.  Every step draws new rows."""

    def __init__(self, vocab: int, batch: int, seq: int, zipf: float,
                 seed: int, device):
        self.batch, self.seq, self.seed = batch, seq, seed
        self.device = torch.device(device)
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=self.device)
        w = ranks ** (-float(zipf))
        self.cdf = torch.cumsum(w / w.sum(), 0)
        self.cdf[-1] = 1.0
        self.vocab = vocab

    def __call__(self, step: int) -> dict[str, torch.Tensor]:
        gen = generator(self.device, self.seed, BATCH, step)
        u = torch.rand((self.batch, self.seq + 1), generator=gen,
                       dtype=torch.float64, device=self.device)
        ids = torch.searchsorted(self.cdf, u, right=True).clamp_(
            max=self.vocab - 1)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous()}
