"""The port's dry run (``launch/dryrun.py``, ``launch/trace_cost.py``,
``launch/mesh.fake_world``) and ``launch/serve.py --shape``, on the CPU.

* ``ArchConfig.n_params`` / ``n_active_params`` are the reference's for
  every config and its ``reduced()`` variant; ``production_mesh`` is the
  reference's mesh as ``split_node_axes`` splits it.
* The walker holds to closed forms, as ``tests/test_hlo_cost.py`` holds
  the reference's: L layers cost L times one, a matmul chain is exact,
  the wire factors at g = 2, 4 and 16, ``--fused-attn`` drops exactly
  the scores; the kernel wrappers refuse on meta what the card refuses.
* Reduced train, prefill and decode steps of every kind give the same
  record on the meta device as on CPU tensors over the same fake 2x2
  world, the matmul FLOPs included (a kernel wrapper's call is one opaque
  record on every device, its plain version's products on the CPU
  unwalked).
* At a fake 2x2 world the Zen sync's wire bytes are the registry's
  ``wire_words_fn`` x 4; ``make_ctx`` refuses at M = 16 exactly where the
  reference's does, with its message; ``fake_world`` leaves no group.
* Against the reference's XLA dry run at 1x1 (reduced qwen2 and mamba2):
  the same ``tokens_per_step``; decode's matmul FLOPs equal exactly; the
  walked totals within the band stated below; the training ratio that
  the reference's per-layer remat adds.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.analysis.hlo_ir import HloModule
from repro.configs import get_config as ref_config
from repro.launch import hlo_cost
from repro.launch.mesh import make_mesh, split_node_axes
from repro.models.common import make_ctx as ref_make_ctx
from repro.train import steps as rst
from repro.train.build import attach_serve as ref_attach_serve
from repro.train.build import attach_train as ref_attach_train
from repro.train.build import build_program as ref_build_program
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.core import registry as preg
from repro_torch.core import schemes as S
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, serve
from repro_torch.launch.mesh import fake_world, mesh_groups, production_mesh
from repro_torch.launch.trace_cost import CostMode, analyze, collective_wire
from repro_torch.models import moe
from repro_torch.models.common import make_ctx
from repro_torch.train.steps import TrainerConfig

META = torch.device("meta")


# ---------------------------------------------------------------------------
# configs and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_equal_the_reference(arch):
    for port, ref in ((get_config(arch), ref_config(arch)),
                      (get_config(arch).reduced(), ref_config(arch).reduced())):
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("multi_pod,node_size",
                         [(False, 1), (False, 4), (True, 1), (True, 16),
                          (False, 3)])
def test_production_mesh_is_the_reference_split(multi_pod, node_size):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if 16 % node_size:
        with pytest.raises(ValueError, match="does not divide"):
            split_node_axes(shape, axes, node_size)
        with pytest.raises(ValueError, match="does not divide"):
            production_mesh(multi_pod, node_size)
        return
    pods, dp, tp = production_mesh(multi_pod, node_size)
    rshape, raxes = split_node_axes(shape, axes, node_size)
    sizes = dict(zip(raxes, rshape))
    assert pods == sizes.get("pod", 1) and tp == sizes["model"]
    assert dp == (sizes["data"] if node_size == 1
                  else sizes["dp_inter"] * sizes["dp_intra"])
    assert pods * dp * tp == (512 if multi_pod else 256)


def test_fake_world_leaves_no_group_behind():
    assert not dist.is_initialized()
    with fake_world(8, rank=3) as world:
        assert (world.n, world.ranks) == (8, (3,))
        with pytest.raises(RuntimeError, match="exists already"):
            with fake_world(2):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="boom"):
        with fake_world(4):
            raise ValueError("boom")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the walker against closed forms
# ---------------------------------------------------------------------------

def _walk(fn, *args, exclude=None) -> dict:
    with CostMode() as cm:
        fn(*args)
    return analyze(cm, exclude=exclude)


def test_layers_multiply_flops_and_bytes():
    x = torch.empty((128, 128), device=META)

    def layers(n):
        def fn(h):
            for _ in range(n):
                h = torch.tanh(h @ w)
            return h
        return _walk(fn, x)
    w = torch.empty((128, 128), device=META)
    one, seven = layers(1), layers(7)
    assert one["flops"] == 2 * 128 ** 3 + 128 ** 2
    assert seven["flops"] == 7 * one["flops"]
    assert seven["bytes"] == 7 * one["bytes"] == 7 * 2 * 2 * 128 * 128 * 4


def test_matmul_chain_is_exact_and_views_are_free():
    a = torch.empty((32, 64), device=META)
    b = torch.empty((64, 48), device=META)
    c = torch.empty((48, 16), device=META)
    def chain():
        x = a @ b @ c
        return x.reshape(-1)[:8], x.t()[:4]
    r = _walk(chain)
    assert r["flops"] == 2 * 32 * 64 * 48 + 2 * 32 * 48 * 16
    assert r["bytes"] == 2 * 4 * (32 * 48 + 32 * 16)
    bb = torch.empty((3, 32, 64), device=META)
    r = _walk(lambda: torch.baddbmm(torch.empty((3, 32, 48), device=META),
                                    bb, torch.empty((3, 64, 48),
                                                    device=META)))
    # the product, and |result| for each of the two empty() it reads
    assert r["flops"] == 2 * 3 * 32 * 48 * 64 + 3 * 32 * 48 + 3 * 64 * 48


@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_wire_factors(g):
    x = torch.empty(64, device=META)            # 256 B of f32
    with fake_world(16) as world:
        grp = S.DistGroup(dist.new_group(list(range(g))))
        with CostMode() as cm:
            grp.psum(x[None])
            grp.all_gather(torch.empty((1, 64 // g), device=META))
            grp.all_to_all(torch.empty((1, g, 64 // g), device=META))
            grp.ppermute(x[None], [(i, (i + 1) % g) for i in range(g)])
        del world
    r = analyze(cm)
    assert r["collectives"] == pytest.approx({
        "all-reduce": 2 * (g - 1) / g * 256, "all-gather": (g - 1) / g * 256,
        "all-to-all": (g - 1) / g * 256, "collective-permute": 256.0})
    assert r["collective_bytes_total"] == pytest.approx(
        sum(r["collectives"].values()))
    assert collective_wire(cm) == pytest.approx(
        {f"{k}/{g}": v for k, v in r["collectives"].items()})


def test_fused_attn_drops_exactly_the_scores():
    B, S_, H, KV, hd = 2, 256, 4, 2, 64
    q = torch.empty((B, S_, H, hd), dtype=torch.bfloat16, device=META)
    k = torch.empty((B, S_, KV, hd), dtype=torch.bfloat16, device=META)
    full = _walk(lambda: ops.flash_fwd_op(q, k, k))
    fused = _walk(lambda: ops.flash_fwd_op(q, k, k), exclude="flash_fusable")
    assert full["bytes"] - fused["bytes"] == 2 * 4 * B * H * S_ * S_
    assert fused["bytes"] == 2 * (2 * q.numel() + 2 * k.numel())
    assert fused["flops"] == 4 * B * H * S_ * (S_ + 1) // 2 * hd


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset",
                         [(7, 7, True, 0, 0), (5, 9, True, 3, 4),
                          (1, 13, True, 0, 12), (6, 6, False, 2, 0),
                          (4, 5, False, 0, 0), (9, 4, True, 0, 0)])
def test_flash_pairs_count_the_kept_keys(Sq, Sk, causal, window, q_offset):
    """``kernel_cost``'s pair count against the plain version's mask, key
    by key."""
    kept = sum(1 for i in range(Sq) for j in range(Sk)
               if (not causal or j <= q_offset + i)
               and (window <= 0 or j > q_offset + i - window))
    assert ops._flash_pairs(Sq, Sk, causal, window, q_offset) == kept


def test_meta_kernels_refuse_what_the_card_refuses():
    q = torch.empty((1, 8, 2, 48), dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError, match="hd in"):
        ops.flash_fwd_op(q, q, q)
    x = torch.empty((1, 64, 2, 128), device=META)
    dA = torch.empty((1, 64, 2), device=META)
    bm = torch.empty((1, 64, 16), device=META)
    with pytest.raises(ValueError, match="hd in"):
        ops.ssd_fwd_op(x, dA, bm, bm, chunk=64)
    ops.reset_counts()
    y, st = ops.ssd_fwd_op(x[..., :64].contiguous(), dA, bm, bm, chunk=64)
    assert y.is_meta and st.shape == (1, 2, 64, 16)
    assert not any(ops.LAUNCHES.values()) and not any(ops.PLAIN_CALLS.values())


def test_moe_route_is_shape_static_on_meta():
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              n_experts=8)
    cap = moe.capacity(64, cfg)
    r = moe.route(torch.empty((64, 8), device=META), 2, cap)
    assert r["pair_of_slot"].shape == (8 * cap,)
    assert moe.expert_share(r["eidx"], 8).shape == (8,)


# ---------------------------------------------------------------------------
# meta against CPU tensors, the Zen sync's wire, make_ctx's refusals
# ---------------------------------------------------------------------------

SPEC = {m: dict(mode=m, seq_len=32, global_batch=4)
        for m in ("train", "prefill", "decode")}


def _trace(cfg, mode: str, device, mesh=(1, 2, 2)) -> dict:
    with fake_world(mesh[0] * mesh[1] * mesh[2]) as world:
        prog = dryrun.build_on(cfg, mesh, world, TrainerConfig(), device)
        return dryrun.trace_step(prog, SPEC[mode])


@pytest.mark.parametrize("arch,mode", [("qwen2-0.5b", "train"),
                                       ("qwen2-0.5b", "prefill"),
                                       ("qwen2-0.5b", "decode"),
                                       ("mamba2-370m", "prefill"),
                                       ("zamba2-1.2b", "train"),
                                       ("olmoe-1b-7b", "train"),
                                       ("whisper-medium", "prefill"),
                                       ("pixtral-12b", "decode"),
                                       ("minicpm3-4b", "prefill")])
def test_meta_record_equals_cpu_record(arch, mode):
    cfg = get_config(arch).reduced()
    meta, cpu = _trace(cfg, mode, "meta"), _trace(cfg, mode, "cpu")
    for key in ("walked", "memory", "kernel_calls"):
        assert meta[key] == cpu[key], key
    # decode attends plain, but whisper's cross-attention (flash_fwd)
    assert bool(meta["kernel_calls"]) == (mode != "decode")
    assert meta["torch_flops"] == cpu["torch_flops"]
    assert meta["walked"]["flops"] > 0 and meta["memory"]["temp_bytes"] > 0


def test_zen_sync_wire_at_a_fake_2x2_world():
    spec = preg.get_scheme("zen")
    M, n = 4096, 2
    layout = S.make_zen_layout(M, n, density_budget=min(
        1.0, 2 * spec.lint_density))
    args = preg.StageArgs(**{**(spec.lint_caps_fn(M, n)
                                if spec.lint_caps_fn else {}),
                             "backend": "cuda", "layout": layout})
    words = spec.wire_words_fn(M, n, preg.stage_kwargs(spec, args))
    with fake_world(4) as world:
        data, model = mesh_groups(world, 2)
        assert (data.n, model.n) == (2, 2)
        layout.tables(META)
        with CostMode() as cm:
            S.stage_sync("zen", torch.empty((1, M), device=META),
                         group=data, n=n, stage_args=args)
        del world
    wire = collective_wire(cm)
    assert set(wire) <= {f"{k}/2" for k in spec.expected_collectives}
    assert sum(wire.values()) == pytest.approx(words * 4, rel=1e-12)
    kinds = [r.op for r in cm.records if r.op.startswith("kernel:")]
    assert kinds == ["kernel:zen_encode", "kernel:zen_commit_push",
                     "kernel:zen_commit_pull"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_ctx_refuses_where_the_reference_does(arch):
    for pad in (False, True):
        errs = []
        # the port's context holds its model group: a stand-in of 16 ranks
        for mk, cfg, kw in (
                (make_ctx, get_config(arch), {"group": types.SimpleNamespace(
                    n=16, ranks=(0,), pg=None)}),
                (ref_make_ctx, ref_config(arch), {})):
            try:
                mk(cfg, 16, 16, pad_heads=pad, **kw)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


def test_dryrun_cli_writes_a_record(tmp_path, monkeypatch):
    cfg = get_config("qwen2-0.5b").reduced()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {"decode_32k": dict(
        mode="decode", seq_len=64, global_batch=32)})
    monkeypatch.setattr(dryrun, "production_mesh",
                        lambda mp, ns: (2, 2, 2) if mp else (1, 2, 2))
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(tmp_path)]) == 0
    import json
    for tag, mesh in (("sp", "2x2"), ("mp", "2x2x2")):
        rec = json.loads((tmp_path / f"qwen2-0.5b__decode_32k__{tag}.json")
                         .read_text())
        assert rec["mesh"] == mesh and rec["tokens_per_step"] == 32
        assert rec["n_params"] == cfg.n_params()
        assert rec["memory"]["peak_bytes"] == (
            rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"])


# ---------------------------------------------------------------------------
# against the reference's XLA dry run at 1x1
# ---------------------------------------------------------------------------

# The port's walked FLOPs sit this far below the reference's: the
# reference's walker counts every elementwise op inside XLA's fusions
# (and a decode cache's dynamic-update-slice whole), and its prefill
# attention and SSD scan are the interpret-mode Pallas kernels on padded
# 128-wide blocks, where the port's kernel records count the kept pairs.
# Decode's matmul FLOPs carry none of that and are held exactly.
WALK_BAND = (0.3, 1.05)
REF_SPEC = dict(seq_len=64, global_batch=2)


def _dot_flops(module, name: str, memo: dict) -> float:
    """The reference's walker restricted to its dots, trip counts kept."""
    if name in memo:
        return memo[name]
    memo[name] = 0.0
    comp = module.computations.get(name)
    ops_ = comp.ops if comp else []
    shapes = {op.name: op.shape for op in ops_}
    total = 0.0
    for op in ops_:
        sub = sum(_dot_flops(module, c, memo) for c in op.called)
        if op.kind == "dot":
            total += hlo_cost._dot_flops(op, shapes)
        elif op.kind == "while":
            total += sub * (op.trip_count or 1)
        elif op.kind in ("fusion", "call", "async-start"):
            total += sub
    memo[name] = total
    return total


def _reference(arch: str, mode: str) -> dict:
    cfg = ref_config(arch).reduced()
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    S_, B = REF_SPEC["seq_len"], REF_SPEC["global_batch"]
    if mode == "train":
        ref_attach_train(prog, S_, B)
        opt = rst.abstract_opt_state(prog.tcfg, prog.param_shapes,
                                     prog.model.ctx, prog.param_specs,
                                     gradsync=prog.gradsync)
        step, args = prog.train_step, (prog.param_shapes, opt,
                                       prog.batch_specs["shapes"])
    else:
        ref_attach_serve(prog, S_, B, mode)
        if mode == "prefill":
            step, args = prog.prefill_step, (prog.param_shapes,
                                             prog.batch_specs["shapes"])
        else:
            step, args = prog.decode_step, (
                prog.param_shapes, prog.cache_specs["global_shapes"],
                jax.ShapeDtypeStruct((B, 1), jnp.int32))
    txt = step.lower(*args).compile().as_text()
    module = HloModule.parse(txt)
    return {**hlo_cost.analyze(txt),
            "dots": _dot_flops(module, module.entry_name, {}),
            "tokens_per_step": B * (1 if mode == "decode" else S_)}


def _port(arch: str, mode: str) -> dict:
    return dryrun.dryrun_combo(arch, None, False,
                               cfg=get_config(arch).reduced(),
                               spec=dict(mode=mode, **REF_SPEC),
                               mesh=(1, 1, 1))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_serve_records_against_the_reference(arch):
    for mode in ("prefill", "decode"):
        ref, port = _reference(arch, mode), _port(arch, mode)
        assert port["tokens_per_step"] == ref["tokens_per_step"]
        ratio = port["flops_per_device"] / ref["flops"]
        assert WALK_BAND[0] < ratio < WALK_BAND[1], (mode, ratio)
        if mode == "decode":
            assert port["torch_flops_per_device"] == ref["dots"]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_training_ratio_of_the_reference_remat(arch):
    """The reference's layers are ``jax.checkpoint``-ed (its
    ``models/model.py:229``) and so are the port's (``models/model.py``'s
    ``recompute``): both backwards run each layer's forward again, so
    their matmul FLOPs a step agree but for what one side alone counts.
    mamba2: about 1 (0.981 measured).  qwen2 (1.407 measured): the
    reference's attention pads the keys to its 512-key block (S is 64
    here), and the port's meta trace holds the attention forward (and
    its recompute) as one opaque ``flash_fwd`` record, so FLOP counting
    sees only its blockwise backward's five products; without the
    attention products the ratio is mamba2's (0.969 measured)."""
    ref, port = _reference(arch, "train"), _port(arch, "train")
    assert port["tokens_per_step"] == ref["tokens_per_step"]
    ref_dots, port_dots = ref["dots"], port["torch_flops_per_device"]
    if arch == "qwen2-0.5b":
        cfg = get_config(arch).reduced()
        B, S = REF_SPEC["global_batch"], REF_SPEC["seq_len"]
        pair = 2 * B * cfg.n_heads * cfg.hd          # a product, a (q, k)
        padded = -(-S // 512) * 512
        # forward, its remat and the backward's four: 8 products a layer
        ref_dots -= cfg.n_layers * 8 * pair * S * padded
        port_dots -= cfg.n_layers * 5 * pair * S * S
    assert 0.95 < ref_dots / port_dots < 1.05, ref_dots / port_dots
    if arch == "qwen2-0.5b":
        assert 1.2 < ref["dots"] / port["torch_flops_per_device"] < 1.6


# ---------------------------------------------------------------------------
# serve.py --shape
# ---------------------------------------------------------------------------

def test_serve_shape_flags():
    a = serve.parse_args(["--shape", "prefill_32k", "--device", "cpu"])
    assert (a.batch, a.prompt_len) == (32, 32768)
    a = serve.parse_args(["--shape", "decode_32k", "--batch", "8"])
    assert (a.batch, a.prompt_len) == (8, 32)
    with pytest.raises(SystemExit):
        serve.parse_args(["--shape", "prefill_32k", "--prompt-len", "8"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--shape", "train_4k"])
    assert set(INPUT_SHAPES) - {"train_4k"} == {
        "prefill_32k", "decode_32k", "long_500k"}


def test_serve_decode_shape_sizes_the_cache_and_keeps_the_tokens():
    base = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--gen",
            "3", "--device", "cpu"]
    shaped = serve.main(base + ["--shape", "decode_32k"])
    plain = serve.main(base)
    assert shaped["cache_len"] == 32768 and plain["cache_len"] == 32 + 3
    assert (shaped["tokens"] == plain["tokens"]).all()
    long = serve.main(base + ["--shape", "long_500k"])
    assert long["cache_len"] == get_config("qwen2-0.5b").reduced() \
        .sliding_window
    assert (long["tokens"] == plain["tokens"]).all()


if __name__ == "__main__":
    # the numbers PERF.md quotes: the port's walked FLOPs, bytes and
    # matmul FLOPs beside the reference's at 1x1, reduced configs
    for arch in ("qwen2-0.5b", "mamba2-370m"):
        for mode in ("prefill", "decode", "train"):
            ref, port = _reference(arch, mode), _port(arch, mode)
            print(f"{arch} {mode}: flops port {port['flops_per_device']:.6g}"
                  f" ref {ref['flops']:.6g} (ratio "
                  f"{port['flops_per_device'] / ref['flops']:.3f}); bytes "
                  f"port {port['bytes_per_device']:.6g} ref "
                  f"{ref['bytes']:.6g}; matmul flops port "
                  f"{port['torch_flops_per_device']:.6g} ref dots "
                  f"{ref['dots']:.6g} (ref / port "
                  f"{ref['dots'] / port['torch_flops_per_device']:.3f})")
