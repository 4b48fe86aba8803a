"""Training mixes: the port's data-parallel trainer in a closed loop.

The program is built as ``launch/train.py`` builds it:
``train.build.build_program(config, mesh, TrainerConfig(...))`` and
``attach_train``, all data ranks of the mesh held in one process on the
in-process group, Zen on ``embed/table``, a psum on the other leaves,
ZeRO-1 AdamW, bf16.  Its parameters then take the weights drawn from the
seed (``harness/inputs.py``).

Set-up drives that one program through its first ``CHECK_STEPS`` steps
through the window's own call and feed (each step new rows), reading
what the comparison needs: each step's loss, the first gradient as the
optimizer got it (its first moment after one step over (1 - b1)) and
the parameters' change after the steps.  Those steps also build and warm
every kernel and shape.  The window then calls ``prog.train_step`` back
to back, each step starting when the host returns from the last, until
``seconds`` have passed, and ends in a device sync.  A traced run then
profiles ``traced_steps`` more steps.  Last, the program is freed and the
plain reference follows the same first steps from the same inputs.
"""
from __future__ import annotations

import gc
import sys
import time

import torch
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.kernels import _build, ops
from repro_torch.models.common import ArchConfig
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

from harness import inputs, tracing, trainref, yardstick

# the steps the comparison follows (the reference's time, 37 s at
# qwen2-0.5b's 65,536 tokens a step, stays under the window's)
CHECK_STEPS = 3


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def build(cell, device, backend: str = "cuda"):
    """The port's trainer for ``cell`` on ``device`` (its weights still the
    port's own draw) and the configuration's sizes."""
    dm = inputs.dims(cell.config)
    tr = cell.traffic
    if cell.config.get("torch_dtype") != "bfloat16":
        raise ValueError("the training runner runs bf16 configurations")
    if {"compress", "bucket_bytes"} & set(tr):
        raise ValueError("the training runner and its reference sync "
                         "uncompressed gradients leaf by leaf")
    if torch.device(device).type == "cuda":
        _build.build()      # every kernel, one nvcc each, in parallel
    arch = ArchConfig(
        name=cell.config_name, kind="dense", n_layers=dm.layers,
        d_model=dm.d, n_heads=dm.heads, n_kv=dm.kv, head_dim=dm.hd,
        d_ff=dm.ff, vocab=dm.vocab, qkv_bias=dm.qkv_bias,
        rope_theta=dm.theta, dtype=torch.bfloat16)
    opt = tr["optimizer"]
    tcfg = TrainerConfig(
        opt=OptConfig(kind="adamw", lr=opt["lr"], b1=opt["b1"],
                           b2=opt["b2"], eps=opt["eps"],
                           weight_decay=opt["weight_decay"],
                           grad_clip=opt["grad_clip"]),
        sync=SyncConfig(scheme=tr["sync"], backend=backend),
        zero1=True)
    prog = build_program(arch, tr["mesh"], tcfg, device=device, seed=0,
                              backend=backend)
    if prog.n_data != tr["data_ranks"]:
        raise ValueError(f"mesh {tr['mesh']} has {prog.n_data} data ranks, "
                         f"the mix says {tr['data_ranks']}")
    eps = {m.eps for m in prog.model.modules() if hasattr(m, "eps")}
    if eps != {dm.eps}:
        raise ValueError(f"the port's norms use eps {sorted(eps)}, the "
                         f"configuration states {dm.eps}")
    attach_train(prog)
    return prog, dm


@torch.no_grad()
def load_weights(prog, dm, seed: int) -> None:
    """Copy the seed's weights into the program's parameters; the leaf
    names, shapes and dtypes have to be the yardstick's."""
    w = inputs.weights(dm, seed, prog.device)
    mine = dict(prog.model.named_leaves())
    want = {n: (tuple(t.shape), t.dtype) for n, t in w.items()}
    have = {n: (tuple(p.shape), p.dtype) for n, p in mine.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:4]
        raise ValueError(f"the port's leaves differ from the configuration's:"
                         f" {diff}")
    for n, p in mine.items():
        p.copy_(w[n])


def feed(cell, dm, seed: int, device) -> inputs.Batches:
    tr = cell.traffic
    return inputs.Batches(dm.vocab, tr["data_ranks"] * tr["batch_per_rank"],
                          tr["seq_len"], tr["zipf"], seed, device)


def check_steps(prog, dm, batches, seed: int, opt: dict,
                steps: int = CHECK_STEPS) -> dict:
    """The program's first ``steps`` steps and its readings
    (``trainref``'s)."""
    losses, grad = [], None
    for step in range(steps):
        m = prog.train_step(batches(step))
        losses.append(float(m["loss"]))
        if step == 0:
            state = prog.train_step.state["leaves"]
            grad = {n: float(st["m"].norm()) / (1 - opt["b1"])
                    for n, st in state.items()}
    w0 = inputs.weights(dm, seed, prog.device)
    with torch.no_grad():
        change = {n: float((p.float() - w0[n].float()).norm())
                  for n, p in prog.model.named_leaves()}
    return {"loss": losses, "grad": grad, "change": change}


def reset_state(prog) -> None:
    """A fresh optimizer state in place: moments zero, step 0 (what
    ``attach_train`` makes, without rebuilding the plan)."""
    st = prog.train_step.state
    with torch.no_grad():
        for mom in st["leaves"].values():
            for t in mom.values():
                t.zero_()
    st["step"] = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        backend: str, t_process: float) -> dict:
    """One run of a training cell: set-up with the check steps, the
    window, the traced steps when ``trace``, then the reference."""
    tr = cell.traffic
    t = time.time()
    prog, dm = build(cell, device, backend)
    log(f"built in {time.time() - t:.2f} s ({t - t_process:.2f} s before)")
    t = time.time()
    load_weights(prog, dm, seed)
    batches = feed(cell, dm, seed, prog.device)
    checked = CHECK_STEPS
    readings = check_steps(prog, dm, batches, seed, tr["optimizer"])
    step = checked
    _sync(device)
    log(f"weights and {checked} check steps in {time.time() - t:.2f} s;"
        f" losses {readings['loss']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_process

    host_s, n = [], 0
    t0 = time.perf_counter()
    while True:
        b = batches(step + n)
        h0 = time.perf_counter()
        prog.train_step(b)
        host_s.append(time.perf_counter() - h0)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    step += n
    log(f"window: {n} steps in {window_s:.3f} s, host {sum(host_s):.3f} s, "
        f"peak {peak} B")
    tokens = tr["data_ranks"] * tr["batch_per_rank"] * tr["seq_len"]
    metrics = {"train_tokens_per_s": (n * tokens / window_s, "tokens/s"),
               "peak_gib": (peak / 2**30, "GiB"),
               "setup_s": (setup_s, "s")}

    record = None
    if trace and cuda:
        rec = tracing.CallRecorder()
        last = {}

        def traced(i):
            last["m"] = prog.train_step(batches(step + i))

        targets = {"bench.sync": (GradSync, "__call__", False),
                   "bench.attn_bwd": (ops.FlashAttn, "backward", True)}
        ops.TRACE = rec
        t = time.time()
        try:
            with tracing.spans(targets):
                record = tracing.profile(traced, tr["traced_steps"], targets)
        finally:
            ops.TRACE = None
        log(f"profiled and reduced in {time.time() - t:.2f} s")
        m = last["m"]
        log(f"traced {tr['traced_steps']} steps: window {record['window_s']:.3f}"
            f" s, busy {record['busy_s']:.3f} s, {len(rec.calls)} calls")
        record.update(
            calls=rec.finish(), traced_steps=tr["traced_steps"],
            window={"steps": n, "seconds": window_s, "host_step_s": host_s},
            flops_per_step=yardstick.train_step_flops(
                dm, tokens, tr["data_ranks"] * tr["batch_per_rank"],
                tr["seq_len"]),
            sync_words=float(m["sync/sparse_sent_words"])
            + float(m["sync/dense_words"]),
            peaks=yardstick.peaks(torch.cuda.get_device_name()))
        del m, last
    del prog, b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.time()
    ref = trainref.readings(cell.reference(), dm, tr, seed, device,
                            steps=checked)
    log(f"reference in {time.time() - t:.2f} s; losses {ref['loss']}")
    return {"metrics": metrics, "record": record, "program": readings,
            "reference": ref, "attempted": checked + n + (
                tr["traced_steps"] if record else 0),
            "failed": sum(1 for x in readings["loss"]
                          if x != x or abs(x) == float("inf")),
            "peak_bytes": peak}
