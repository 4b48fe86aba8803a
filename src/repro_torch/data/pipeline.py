"""Synthetic Zipf token stream (numpy copy of ``repro.data.pipeline``).

Token ids follow a Zipf distribution over the vocabulary, the frequency law
that makes embedding gradients row-sparse and skewed.  Deterministic per
(seed, step, shard): the same seed yields the reference's batches.  An
encoder-decoder config's batches add stub ``frames`` [batch, enc_len,
d_model] and a VLM's stub ``patches`` [batch, n_patches, d_model],
float32 normals x 0.02 drawn from the same generator after the tokens, as
the reference draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    batch: int              # batch drawn per step
    zipf: float = 1.2       # token-frequency skew
    seed: int = 0


class SyntheticLM:
    """Infinite stream of {tokens, labels} int32 [batch, seq_len] (+ the
    frames or patches stubs)."""

    def __init__(self, cfg: ArchConfig, dc: DataConfig, shard: int = 0):
        self.cfg, self.dc, self.shard = cfg, dc, shard
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-dc.zipf)
        self._p = w / w.sum()
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.dc.seed, self._step, self.shard))
        self._step += 1
        cfg, B = self.cfg, self.dc.batch
        toks = rng.choice(cfg.vocab, size=(B, self.dc.seq_len + 1),
                          p=self._p).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.kind == "enc_dec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_len, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.kind == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        return batch
