"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: a CUDA GPU must be present; prints its name and power limit.
  2. kernels: builds the CUDA kernels from ``src/repro_torch/csrc`` and
     holds each against its plain PyTorch version on the card at the
     qwen2-0.5b Zen slice shapes (M = 151936 embedding rows, d = 896,
     n = 8): a realistic stream (512 tokens per rank), a dense stream near
     the capacity budget, and an overflow-edge layout; f32 and bf16.  Every
     output must be bitwise equal.
  3. zen_sync: n = 8 simulated ranks at M = 151936, d = 896, bf16;
     ``backend="cuda"`` must equal ``backend="torch"`` bitwise.
  4. trainer: ``launch/train.py --arch qwen2-0.5b --mesh 8x1 --sync zen
     --global-batch 8 --seq-len 512 --steps 4`` at full width and depth;
     finite, falling loss, no overflow, every kernel launched 8 x steps
     times, no call on the plain route.
  5. breakdown: one profiled trainer step (torch.profiler): device time by
     kernel category and the device's idle share.
  6. times: median of 20 CUDA-event timings of each kernel and its plain
     version at the slice shapes, with the least time the card could take.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
SLICE = dict(M=151936, d=896, n=8, density_budget=0.25, tokens=512)
REPLACES = {
    "zen_encode": "src/repro/kernels/zen_encode.py:108",
    "zen_commit_push": "src/repro/kernels/zen_commit.py:104",
    "zen_commit_pull": "src/repro/kernels/zen_commit.py:163",
}
SOURCES = {
    "zen_encode": "src/repro_torch/csrc/zen_encode.cu",
    "zen_commit_push": "src/repro_torch/csrc/zen_commit.cu",
    "zen_commit_pull": "src/repro_torch/csrc/zen_commit.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor's bits, for bitwise comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def same(a, b, what: str) -> float:
    """Assert kernel outputs ``a`` equal plain outputs ``b`` bit for bit;
    returns the largest absolute difference (0.0 when they are equal)."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape == y.shape and x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        if x.shape != y.shape or x.dtype != y.dtype \
                or not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version ({x.dtype} {tuple(x.shape)} vs "
                                 f"{y.dtype} {tuple(y.shape)}, max abs "
                                 f"difference {worst})")
    return worst


def zipf_rows(rng, n: int, vocab: int, tokens: int, d: int, dtype, dev):
    """[n, vocab, d] worker gradients: each worker's rows are the distinct
    ids of ``tokens`` Zipf(1.2) draws (the trainer's data law), random
    values."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.2
    p /= p.sum()
    g = torch.zeros((n, vocab, d), dtype=dtype, device=dev)
    for w in range(n):
        ids = np.unique(rng.choice(vocab, size=tokens, p=p))
        idx = torch.as_tensor(ids, device=dev)
        v = torch.as_tensor(rng.standard_normal((ids.size, d)), device=dev)
        g[w, idx] = v.to(dtype)
    return g


def dense_rows(rng, n: int, vocab: int, density: float, d: int, dtype, dev):
    """[n, vocab, d] worker gradients with a uniform row density."""
    g = torch.zeros((n, vocab, d), dtype=dtype, device=dev)
    for w in range(n):
        idx = torch.as_tensor(np.flatnonzero(rng.random(vocab) < density),
                              device=dev)
        g[w, idx] = torch.randn((idx.numel(), d), device=dev).to(dtype)
    return g


def kernel_inputs(g: torch.Tensor, lo):
    """The three kernels' inputs on the zen_sync path for worker/server 0:
    the compacted index vector, the server's pushed stream, the gathered
    server bitmaps (built with the plain route)."""
    from repro_torch.core import schemes as S
    from repro_torch.core.hashing import EMPTY, compact_rows
    from repro_torch.kernels import ref as R

    enc = S.zen_encode(g, layout=lo, backend="torch")
    idx = compact_rows(S._worker_mask(g), lo.cap_index)[0][0].contiguous()
    grp = S.SimGroup(lo.n)
    got_idx = grp.all_to_all(enc.pidx).reshape(lo.n, -1)
    got_val = grp.all_to_all(enc.pval).reshape(lo.n, -1, g.shape[-1])
    tab = lo.tables(g.device)["local_pos"]
    live = got_idx != EMPTY
    lp = torch.where(live, tab[torch.where(live, got_idx, 0).long()],
                     lo.cap_server).to(torch.int32)
    bms = torch.stack([
        R.zen_commit_push_ref(lp[s], got_val[s], cap_server=lo.cap_server,
                              cap_pull=lo.cap_pull)[2]
        for s in range(lo.n)])
    return idx, lp[0].contiguous(), got_val[0].contiguous(), bms


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | {smi}")
    return {"smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version, bitwise, on the card."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import _build, ops as K, ref as R

    t0 = time.time()
    _build.build(verbose=True)
    log(f"[kernels] built in {time.time() - t0:.1f}s")
    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    log(f"[kernels] layout C={lo.cap_index} r1={lo.r1} r2={lo.r2} "
        f"L={lo.cap_pull} cap_server={lo.cap_server}")
    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in K.KERNELS}
    cases = [("realistic", lo, zipf_rows(rng, n, M, SLICE["tokens"], d,
                                         torch.bfloat16, dev)),
             ("dense", lo, dense_rows(rng, n, M, 0.2, d, torch.bfloat16,
                                      dev))]
    edge = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"],
                             r2_ratio=0.001)
    cases.append(("overflow-edge", edge, cases[1][2]))
    shapes = {}
    for name, lay, g in cases:
        idx, lp, vals, bms = kernel_inputs(g, lay)
        for nm, r2 in (("", lay.r2), ("/r2=4", 4)):
            a = K.zen_encode_fused_op(idx, lay.static_seeds(), n, lay.r1, r2)
            b = R.zen_encode_ref(idx, lay.static_seeds(), n, lay.r1, r2)
            err["zen_encode"] = max(err["zen_encode"],
                                    same(a, b, f"zen_encode {name}{nm}"))
            log(f"[kernels] zen_encode {name}{nm}: equal "
                f"(nnz={int((idx != 2**31 - 1).sum())}, ovf={int(b[2])})")
        caps = [lay.cap_pull] + ([97] if name != "realistic" else [])
        for dtype in (torch.float32, torch.bfloat16):
            for cap_pull in caps:
                v = vals.to(dtype)
                a = K.zen_commit_push_fused_op(lp, v, cap_server=lay.cap_server,
                                               cap_pull=cap_pull)
                b = R.zen_commit_push_ref(lp, v, cap_server=lay.cap_server,
                                          cap_pull=cap_pull)
                err["zen_commit_push"] = max(err["zen_commit_push"], same(
                    a, b, f"zen_commit_push {name} {dtype} cap_pull={cap_pull}"))
                log(f"[kernels] zen_commit_push {name} {dtype} "
                    f"cap_pull={cap_pull}: equal (live rows="
                    f"{int((lp < lay.cap_server).sum())}, ovf={int(b[3])})")
        for cap_pull in caps:
            a = K.zen_commit_pull_fused_op(bms, lay.cap_server, cap_pull)
            b = R.zen_commit_pull_ref(bms, lay.cap_server, cap_pull)
            err["zen_commit_pull"] = max(err["zen_commit_pull"], same(
                [a], [b], f"zen_commit_pull {name} cap_pull={cap_pull}"))
        log(f"[kernels] zen_commit_pull {name}: equal")
        if name == "realistic":
            shapes = dict(idx=idx, lp=lp, vals=vals, bms=bms, lo=lay)
    torch.cuda.synchronize()
    return {"err": err, "inputs": shapes}


def phase_zen_sync(dev) -> None:
    """zen_sync through the kernels == through the plain versions."""
    from repro_torch.core import schemes as S

    M, d, n = SLICE["M"], SLICE["d"], SLICE["n"]
    lo = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"])
    g = zipf_rows(np.random.default_rng(1), n, M, SLICE["tokens"], d,
                  torch.bfloat16, dev)
    a_out, a_st = S.simulate(S.zen_sync, g, layout=lo, backend="cuda")
    b_out, b_st = S.simulate(S.zen_sync, g, layout=lo, backend="torch")
    same([a_out, a_st.sent_words, a_st.overflow],
         [b_out, b_st.sent_words, b_st.overflow], "zen_sync cuda vs torch")
    # and the sum every worker receives is the psum of the inputs
    ref = g.float().sum(0)
    if not torch.allclose(a_out[0].float(), ref, atol=0.1, rtol=0.02):
        raise AssertionError("zen_sync output is not the sum of the inputs")
    log(f"[zen_sync] cuda == torch bitwise; sent_words[0]="
        f"{float(a_st.sent_words[0])} overflow={a_st.overflow.tolist()}")
    del g, a_out, b_out


def phase_trainer(steps: int = 4) -> dict:
    from repro_torch.kernels import ops as K
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-0.5b", "--mesh", "8x1", "--sync", "zen",
            "--global-batch", "8", "--seq-len", "512", "--steps", str(steps),
            "--log-every", "1"]
    K.reset_counts()
    res = train.main(argv)
    launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    losses = res["losses"]
    log(f"[trainer] losses={losses} tok/s={res['tok_per_s']} "
        f"sparse_words={res['sparse_words']} overflow={res['overflow']} "
        f"step_s={res['step_s']} launches={launches} plain={plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"trainer loss not finite and falling: {losses}")
    if res["overflow"] != 0:
        raise AssertionError(f"trainer overflow {res['overflow']}")
    for k in K.KERNELS:
        if launches[k] != 8 * steps:
            raise AssertionError(f"{k} launched {launches[k]} times, "
                                 f"expected {8 * steps}")
        if plain[k]:
            raise AssertionError(f"{k} took the plain route {plain[k]} times")
    # the same run through the plain versions: the sync is bitwise equal,
    # so the losses may differ only by run-to-run noise of the model's own
    # CUDA ops
    plain_res = train.main(argv + ["--backend", "torch"])
    diff = max(abs(a - b) for a, b in zip(losses, plain_res["losses"]))
    log(f"[trainer] plain-route losses={plain_res['losses']} max |diff|="
        f"{diff} tok/s={plain_res['tok_per_s']}")
    if diff > 5e-3:
        raise AssertionError(f"kernel and plain routes diverge: {diff}")
    return {"launches": launches, "plain_route": plain_res, **res}


def _kernel_category(name: str) -> str:
    if "zen_" in name:        # every kernel in csrc/ is named zen_*_kernel
        return "zen kernels"
    if any(g in name.lower() for g in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


def phase_breakdown(steps: int = 2) -> dict:
    """Device time of one trainer step (the smoke config) by kernel
    category, from torch.profiler, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.build import attach_train, build_program

    torch.cuda.empty_cache()
    cfg = get_config("qwen2-0.5b")
    prog = build_program(cfg, "8x1", device="cuda")
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8)))

    def batch():
        return {k: torch.as_tensor(v, device="cuda").long()
                for k, v in next(data).items()}

    for _ in range(steps - 1):            # warm-up
        prog.train_step(batch())
    b = batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.train_step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats: dict[str, float] = {}
    names: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            c = _kernel_category(e.name)
            cats[c] = cats.get(c, 0.0) + ms
            names[e.name] = names.get(e.name, 0.0) + ms
    busy = sum(cats.values())
    out = {"wall_ms": wall_ms, "device_ms": cats, "busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if busy else None}
    log(f"[breakdown] step wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"(idle share {out['idle_share']}), by category "
        f"{ {k: round(v, 3) for k, v in cats.items()} }")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[breakdown]   {ms:9.3f} ms  {name[:110]}")
    del prog
    torch.cuda.empty_cache()
    return out


def phase_times(inp: dict, smi: str) -> list:
    from repro_torch.kernels import ops as K, ref as R

    lo, idx, lp, vals, bms = (inp[k] for k in ("lo", "idx", "lp", "vals",
                                                "bms"))
    n, L, d = lo.n, lo.cap_pull, vals.shape[1]
    W = -(-L // 32)
    live = int((lp < lo.cap_server).sum())
    el = vals.element_size()
    seeds = lo.static_seeds()
    rows = {
        "zen_encode": (
            lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
            lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
            idx.numel() * 4 + n * (L + W + 1) * 4),
        "zen_commit_push": (
            lambda: K.zen_commit_push_fused_op(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lambda: R.zen_commit_push_ref(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lp.numel() * 4 + live * d * el + L * (4 + d * el)
            + lo.cap_bitmap_words * 4 + 4),
        "zen_commit_pull": (
            lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
            lambda: R.zen_commit_pull_ref(bms, lo.cap_server, L),
            bms.numel() * 4 + n * L * 4),
    }
    out = []
    for name, (kern, plain, nbytes) in rows.items():
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "bytes": nbytes})
        log(f"[times] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms from {nbytes} B) | {smi}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases to run (debugging); default "
                         "all: kernels,zen_sync,trainer,breakdown,times")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    want = (lambda p: not only or p in only)
    t_start = time.time()
    dev_info = phase_device()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = phase_kernels(dev) if want("kernels") or want("times") else None
    if want("zen_sync"):
        phase_zen_sync(dev)
    trainer = phase_trainer() if want("trainer") else None
    if want("breakdown"):
        phase_breakdown()
    times = phase_times(kern["inputs"], dev_info["smi"]) if want("times") \
        else []
    table = []
    for row in times:
        name = row["name"]
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": trainer["launches"][name] if trainer else None,
            "max_abs_err": kern["err"][name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    log(f"[done] {time.time() - t_start:.1f}s | {dev_info['smi']}")
    print(json.dumps({"kernels": table}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    main()
