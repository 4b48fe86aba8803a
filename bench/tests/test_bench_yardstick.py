"""The yardstick's counters against shapes worked by hand, and each
per-layer reader on a record made by hand."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import inputs, spec, tracing, yardstick  # noqa: E402

H100 = yardstick.peaks("NVIDIA H100 80GB HBM3")
QWEN2 = inputs.Dims(layers=24, d=896, heads=14, kv=2, hd=64, ff=4864,
                    vocab=151936, theta=1e6, eps=1e-5, qkv_bias=True)


def test_peaks_are_the_data_sheet_and_only_for_the_h100():
    assert H100["bf16"] == 989e12 and H100["f32"] == 67e12
    assert H100["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.peaks("cpu") is None and yardstick.peaks(None) is None


@pytest.mark.parametrize("args,pairs", [
    ((4, 4, True, 0, 0), 10),          # 1 + 2 + 3 + 4
    ((4, 4, True, 2, 0), 7),           # 1 + 2 + 2 + 2
    ((2, 5, True, 0, 3), 9),           # positions 3, 4: 4 + 5 keys
    ((3, 5, False, 0, 0), 15),         # every key
    ((4096, 4096, True, 0, 0), 8_390_656),
])
def test_kept_pairs(args, pairs):
    assert yardstick.kept_pairs(*args) == pairs


def test_train_step_flops_qwen2_by_hand():
    # per layer: q 896x896, k and v 896x128, o 896x896, three 896x4864
    per_layer = 802_816 + 2 * 114_688 + 802_816 + 3 * 4_358_144
    assert per_layer == 14_909_440
    matrices = 24 * per_layer + 896 * 151_936        # the head, no embedding
    assert matrices == 493_961_216
    attn = 24 * 16 * 14 * 8_390_656 * 2 * 128        # 16 sequences of 4096
    want = 6 * matrices * 65_536 + 3 * attn
    assert yardstick.train_step_flops(QWEN2, 65_536, 16, 4096) == want
    assert 2.2e14 < want < 2.3e14


def test_flash_fwd_bound_by_hand():
    call = {"q": (2, 4096, 14, 64), "k": (2, 4096, 2, 64),
            "v": (2, 4096, 2, 64), "dtype": "bfloat16", "causal": True,
            "window": 0, "q_offset": 0,
            "in_bytes": 2 * 4096 * (14 + 2 + 2) * 64 * 2,
            "out_bytes": 2 * 4096 * 14 * 64 * 2 + 2 * 4096 * 14 * 4}
    flops = 2 * (2 * 14 * 8_390_656) * (64 + 64)
    assert yardstick.flash_fwd_bound(call, H100) == pytest.approx(
        flops / 989e12)
    f32 = dict(call, dtype="float32")
    assert yardstick.flash_fwd_bound(f32, H100) == pytest.approx(
        flops / 67e12)
    # a short row is bound by its bytes
    short = dict(call, q=(1, 1, 14, 64), k=(1, 1, 2, 64), v=(1, 1, 2, 64))
    assert yardstick.flash_fwd_bound(short, H100) == pytest.approx(
        (call["in_bytes"] + call["out_bytes"]) / 3.35e12)


def test_io_bound():
    assert yardstick.io_bound({"in_bytes": 1000, "out_bytes": 2350},
                              H100) == pytest.approx(1e-9)


def test_busy_is_the_union_of_intervals():
    assert tracing._merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3],
                                                                 [5, 9]]


def _record():
    flash = {"name": "flash_fwd", "q": (2, 4096, 14, 64),
             "k": (2, 4096, 2, 64), "v": (2, 4096, 2, 64),
             "dtype": "bfloat16", "causal": True, "window": 0,
             "q_offset": 0, "in_bytes": 10, "out_bytes": 10}
    zen = {"name": "zen_encode", "in_bytes": 1_000_000,
           "out_bytes": 2_350_000}
    bound = yardstick.flash_fwd_bound(flash, H100)
    return {"busy_s": 0.9, "window_s": 1.2, "traced_steps": 2,
            "spans": {"bench.sync": 0.06, "bench.attn_bwd": 0.5},
            "calls": [flash, flash, zen],
            "kernels": {"flash_fwd_bf16_mma_kernel<64, 64>": 4 * bound,
                        "zen_encode_kernel": 4e-6, "gemm": 1.0},
            "window": {"steps": 10, "seconds": 20.0,
                       "host_step_s": [0.1, 0.3, 0.2]},
            "flops_per_step": 0.5 * 989e12 * 2.0, "sync_words": 1234.0,
            "peaks": H100}


@pytest.mark.parametrize("name,value", [
    ("idle_share", 77.5), ("step_mfu", 50.0), ("host_step_ms", 200.0),
    ("sync_ms", 30.0), ("sync_words", 1234.0), ("attn_bwd_ms", 250.0),
    ("flash_fwd_roofline", 50.0), ("zen_roofline", 25.0),
])
def test_readers_by_hand(name, value):
    reader = spec.metric_readers(BENCH)[name]
    assert reader.read(_record()) == pytest.approx(value)
    # a reader that finds nothing to read returns nothing, never 0
    assert reader.read({}) is None


def test_weights_and_batches_come_from_the_seed():
    dm = inputs.Dims(layers=1, d=16, heads=2, kv=1, hd=8, ff=32, vocab=100,
                     theta=1e4, eps=1e-5, qkv_bias=True)
    a, b = inputs.weights(dm, 7, "cpu"), inputs.weights(dm, 7, "cpu")
    c = inputs.weights(dm, 2**40 + 7, "cpu")
    assert all(a[n].equal(b[n]) for n in a)
    assert not a["layers/0/attn/q/w"].equal(c["layers/0/attn/q/w"])
    assert a["embed/table"].shape == (128, 16)
    assert not a["embed/table"][100:].any()
    assert not a["lm_head/w"][:, 100:].any()
    feed = inputs.Batches(100, 4, 8, 1.2, 2**33 + 5, "cpu")
    x, y = feed(3), feed(3)
    assert x["tokens"].equal(y["tokens"]) and x["labels"].equal(y["labels"])
    assert x["tokens"][:, 1:].equal(x["labels"][:, :-1])
    assert not feed(4)["tokens"].equal(x["tokens"])
    assert int(x["tokens"].max()) < 100


class _Event:
    """A raw profiler event as ``tracing.reduce`` reads it."""

    def __init__(self, name, start, end, device=False, corr=0, linked=0,
                 thread=1, annotation=False):
        from torch.autograd import DeviceType
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       device_type=DeviceType.CUDA if device
                       else DeviceType.CPU, correlation_id=corr,
                       linked_correlation_id=linked, start_thread_id=thread,
                       is_user_annotation=annotation, is_hidden_event=False)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_the_trace_reduction_by_hand():
    ev = [
        _Event("bench.step", 0, 1000, corr=1),
        _Event("bench.sync", 100, 400, corr=2),
        _Event("aten::add", 120, 130, corr=3),          # inside the sync
        _Event("aten::mul", 500, 510, corr=4),          # outside it
        _Event("bench.attn_bwd", 600, 900, corr=5, thread=2),
        _Event("aten::mm", 610, 620, corr=6, thread=2),
        _Event("k_add", 200, 300, device=True, linked=3),
        _Event("k_mul", 250, 350, device=True, linked=4),   # overlaps k_add
        _Event("k_mm", 700, 760, device=True, linked=6),
        _Event("memset", 800, 810, device=True, linked=0),
        _Event("bench.sync", 150, 390, device=True, annotation=True),
    ]
    rec = tracing.reduce(ev, {"bench.step", "bench.sync", "bench.attn_bwd"},
                         2e-6)
    # busy is the union: [200, 350] + [700, 760] + [800, 810]
    assert rec["busy_s"] == pytest.approx(220e-9)
    assert rec["spans"]["bench.sync"] == pytest.approx(100e-9)
    assert rec["spans"]["bench.attn_bwd"] == pytest.approx(60e-9)
    assert rec["spans"]["bench.step"] == pytest.approx(200e-9)
    assert set(rec["kernels"]) == {"k_add", "k_mul", "k_mm", "memset"}
    gaps = rec["breakdown"]["idle_gaps"]
    # the longest gap, [350, 700], opened while the host was in the sync
    assert gaps[0] == ["bench.sync", pytest.approx(350e-9)]
