"""The yardstick: the chip's published peaks, and the operations and bytes
of the work, counted from shapes alone (never from the program's own cost
code), so that a share of a peak reads the same work whatever implements
it.

* :func:`train_step_flops`: a training step's model FLOPs, 6 x the
  parameters of every matrix the tokens pass through (the head included,
  the embedding lookup not) x the tokens, plus causal attention's score
  and value products (forward and backward, 3 x the forward's), without
  recomputation;
* :func:`flash_fwd_bound`: one ``flash_fwd`` call's least time, the larger
  of its products over the bf16 (or f32) peak and its bytes (q, k, v read
  once, the output and the rows' log-sum-exp written once) over HBM;
* :func:`io_bound`: a kernel whose work is its bytes (the Zen kernels):
  each input read once and each output written once, over HBM.
"""
from __future__ import annotations

import functools

# NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity), at the
# full 700 W power limit
PEAKS = {
    "H100": {"bf16": 989e12, "f16": 989e12, "tf32": 495e12, "f32": 67e12,
             "fp8": 1979e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_kind: str | None) -> dict | None:
    """The peaks of the card named ``device_kind``
    (``torch.cuda.get_device_name()``), or None for another device."""
    for key, table in PEAKS.items():
        if device_kind and key in device_kind:
            return table
    return None


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal sequence of ``s`` keeps."""
    return s * (s + 1) // 2


@functools.lru_cache(maxsize=None)
def kept_pairs(sq: int, sk: int, causal: bool, window: int,
               q_offset: int) -> int:
    """Pairs one head of one sequence keeps: the query at position
    ``q_offset + i`` keeps key j where j <= position (causal) and j >
    position - window (window > 0)."""
    total = 0
    for i in range(sq):
        p = q_offset + i
        hi = min(sk - 1, p) if causal else sk - 1
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def train_step_flops(dm, tokens: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``tokens`` = ``batch`` x
    ``seq`` tokens of the dense decoder ``dm`` (``inputs.Dims``)."""
    d, q, kv = dm.d, dm.heads * dm.hd, dm.kv * dm.hd
    per_layer = d * q + 2 * d * kv + q * d + 3 * d * dm.ff
    matrices = dm.layers * per_layer + d * dm.vocab_padded   # + the head
    attn_fwd = dm.layers * batch * dm.heads * causal_pairs(seq) * 2 * (
        dm.hd + dm.hd)
    return 6.0 * matrices * tokens + 3.0 * attn_fwd


def flash_fwd_bound(call: dict, table: dict) -> float:
    """Seconds one ``flash_fwd`` call needs at least: ``call`` holds the
    shapes ``q`` [B, Sq, H, hd], ``k`` [B, Sk, KV, hd], ``v``, the
    ``dtype`` name, ``causal``, ``window``, ``q_offset``, and the
    ``in_bytes`` / ``out_bytes`` of its tensors."""
    b, sq, h, hd = call["q"]
    sk, hd_v = call["k"][1], call["v"][3]
    pairs = b * h * kept_pairs(sq, sk, call["causal"], call["window"],
                               call["q_offset"])
    flops = 2.0 * pairs * (hd + hd_v)
    peak = table["bf16"] if call["dtype"] == "bfloat16" else table["f32"]
    return max(flops / peak,
               (call["in_bytes"] + call["out_bytes"]) / table["hbm_bytes_per_s"])


def io_bound(call: dict, table: dict) -> float:
    """Seconds a call whose work is its bytes needs at least."""
    return (call["in_bytes"] + call["out_bytes"]) / table["hbm_bytes_per_s"]
