"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: a CUDA GPU must be present; prints its name and power limit.
  2. kernels: builds the CUDA kernels from ``src/repro_torch/csrc`` and
     holds each against its plain PyTorch version on the card at the
     qwen2-0.5b Zen slice shapes (M = 151936 embedding rows, d = 896,
     n = 8): a realistic stream (512 tokens per rank), a dense stream near
     the capacity budget, and an overflow-edge layout; f32 and bf16; for
     the scatter-add also a non-zero ``out`` with EMPTY, negative and
     out-of-range indices, and one target repeated 64 times.  Each fused
     kernel is also held against its unfused chain.  Every output must be
     bitwise equal.
  3. zen_sync: n = 8 simulated ranks at M = 151936, d = 896, bf16;
     ``backend="cuda"`` must equal ``backend="torch"`` bitwise, on the
     fused route and with (fused, fused_commit) in {(F,T), (T,F), (F,F)}.
  4. trainer: ``launch/train.py --arch qwen2-0.5b --mesh 8x1 --sync zen
     --global-batch 8 --seq-len 512 --steps 4`` at full width and depth;
     finite, falling loss, no overflow, every fused-route kernel launched
     8 x steps times, no call on the plain route.  Then the same trainer
     with ``SyncConfig(fused_encode=False, fused_commit=False)``: the same
     checks on the unfused chain's five kernels, the fused kernels not
     launched, the fused run's wire words, losses within 5e-3 of it.
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
# H100 SXM float32 rate outside the tensor cores (data sheet); the integer
# and float work of these kernels runs on the same units, at most this fast
OPS_PER_S = 67e12
SLICE = dict(M=151936, d=896, n=8, density_budget=0.25, tokens=512)
REPLACES = {
    "zen_encode": "src/repro/kernels/zen_encode.py:108",
    "zen_commit_push": "src/repro/kernels/zen_commit.py:104",
    "zen_commit_pull": "src/repro/kernels/zen_commit.py:163",
    "hash_stage": "src/repro/kernels/hash_stage.py:56",
    "row_compact": "src/repro/kernels/compact.py:49",
    "coo_scatter_add": "src/repro/kernels/scatter_add.py:44",
    "bitmap_pack": "src/repro/kernels/bitmap.py:38",
    "bitmap_unpack": "src/repro/kernels/bitmap.py:54",
}
SOURCES = {
    "zen_encode": "src/repro_torch/csrc/zen_encode.cu",
    "zen_commit_push": "src/repro_torch/csrc/zen_commit.cu",
    "zen_commit_pull": "src/repro_torch/csrc/zen_commit.cu",
    "hash_stage": "src/repro_torch/csrc/hash_stage.cu",
    "row_compact": "src/repro_torch/csrc/row_compact.cu",
    "coo_scatter_add": "src/repro_torch/csrc/scatter_add.cu",
    "bitmap_pack": "src/repro_torch/csrc/bitmap.cu",
    "bitmap_unpack": "src/repro_torch/csrc/bitmap.cu",
}
UNFUSED = dict(fused_encode=False, fused_commit=False)


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
    """The kernels' inputs on the zen_sync path for worker/server 0: the
    compacted index vector, its Alg. 1 memory, the server's pushed stream
    and aggregated mask, the gathered server bitmaps (built with the plain
    route)."""
    from repro_torch.core import schemes as S
    from repro_torch.core.hashing import EMPTY, compact_rows, hierarchical_hash
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
    mem = hierarchical_hash(idx, n=lo.n, r1=lo.r1, r2=lo.r2, k=lo.k,
                            seeds=lo.static_seeds()).memory
    mask = (R.coo_scatter_add_ref(lo.cap_server, lp[0], got_val[0]) != 0) \
        .any(dim=-1)
    return dict(idx=idx, mem=mem, lp=lp[0].contiguous(),
                vals=got_val[0].contiguous(), mask=mask, bms=bms)


def scatter_cases(lp: torch.Tensor, vals: torch.Tensor, rows: int, rng):
    """(name, out, idx, vals) cases for the scatter-add at the server's
    shapes: the pushed stream into zeros; a non-zero ``out`` with EMPTY,
    negative and out-of-range indices mixed in; one target repeated 64
    times among the others."""
    dev = vals.device
    cases = [("stream", torch.zeros((rows, vals.shape[1]), dtype=vals.dtype,
                                    device=dev), lp, vals)]
    idx = lp.clone()
    pick = torch.as_tensor(rng.random(idx.numel()) < 0.02, device=dev)
    junk = torch.as_tensor(rng.choice([2**31 - 1, -1, -7, rows, rows + 5],
                                      size=idx.numel()), device=dev)
    idx = torch.where(pick, junk.to(torch.int32), idx).contiguous()
    out = torch.randn((rows, vals.shape[1]), device=dev).to(vals.dtype)
    out[torch.as_tensor(rng.random(rows) < 0.5, device=dev)] = 0
    cases.append(("nonzero-out+junk", out, idx, vals))
    rep = lp.clone()
    live = torch.nonzero(lp < rows)[:, 0]
    rep[live[torch.as_tensor(rng.choice(live.numel(), 64, replace=False),
                             device=dev)]] = 3
    cases.append(("repeat64", out, rep.contiguous(), vals))
    return cases


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

    def check(name, a, b, what):
        err[name] = max(err[name], same(a, b, f"{name} {what}"))

    cases = [("realistic", lo, zipf_rows(rng, n, M, SLICE["tokens"], d,
                                         torch.bfloat16, dev)),
             ("dense", lo, dense_rows(rng, n, M, 0.2, d, torch.bfloat16,
                                      dev))]
    edge = S.make_zen_layout(M, n, density_budget=SLICE["density_budget"],
                             r2_ratio=0.001)
    cases.append(("overflow-edge", edge, cases[1][2]))
    shapes = {}
    for name, lay, g in cases:
        inp = kernel_inputs(g, lay)
        idx, lp, vals, bms = (inp[k] for k in ("idx", "lp", "vals", "bms"))
        seeds = lay.static_seeds()
        for nm, r2 in (("", lay.r2), ("/r2=4", 4)):
            a = K.zen_encode_fused_op(idx, seeds, n, lay.r1, r2)
            b = R.zen_encode_ref(idx, seeds, n, lay.r1, r2)
            check("zen_encode", a, b, f"{name}{nm}")
            # the fused kernel against the unfused chain's kernels
            check("zen_encode", a,
                  K.zen_encode_unfused(idx, seeds, n, lay.r1, r2),
                  f"{name}{nm} vs unfused chain")
            log(f"[kernels] zen_encode {name}{nm}: equal, and to the unfused "
                f"chain (nnz={int((idx != 2**31 - 1).sum())}, ovf={int(b[2])})")
        check("hash_stage", K.hash_stage_op(idx, seeds, n, lay.r1),
              R.hash_stage_ref(idx, seeds, n, lay.r1), name)
        check("row_compact", [K.row_compact_op(inp["mem"])],
              [R.row_compact_ref(inp["mem"])], name)
        mask = inp["mask"]
        for m_len in (mask.numel(), mask.numel() - 5, 64):   # ragged tails
            m = mask[:m_len].contiguous()
            W = -(-m_len // 32)
            bits = torch.zeros(W * 32, dtype=torch.int32, device=dev)
            bits[:m_len] = m.to(torch.int32)
            check("bitmap_pack", [K.bitmap_pack_op(m)],
                  [R.bitmap_pack_ref(bits)], f"{name} M={m_len}")
        words = bms.reshape(-1)
        for length in (words.numel() * 32, lay.cap_server):
            check("bitmap_unpack", [K.bitmap_unpack_op(words, length)],
                  [R.bitmap_unpack_ref(words)[:length] != 0],
                  f"{name} length={length}")
        log(f"[kernels] hash_stage, row_compact, bitmap_pack, bitmap_unpack "
            f"{name}: equal (live slots={int(mask.sum())})")
        caps = [lay.cap_pull] + ([97] if name != "realistic" else [])
        for dtype in (torch.float32, torch.bfloat16):
            v = vals.to(dtype)
            for cname, out, sidx, _ in scatter_cases(lp, v, lay.cap_server,
                                                     rng):
                a = K.coo_scatter_add_op(out.clone(), sidx, v)
                b = R.coo_scatter_add_ref(out, sidx, v)
                check("coo_scatter_add", [a], [b], f"{name}/{cname} {dtype}")
            for cap_pull in caps:
                a = K.zen_commit_push_fused_op(lp, v, cap_server=lay.cap_server,
                                               cap_pull=cap_pull)
                b = R.zen_commit_push_ref(lp, v, cap_server=lay.cap_server,
                                          cap_pull=cap_pull)
                what = f"{name} {dtype} cap_pull={cap_pull}"
                check("zen_commit_push", a, b, what)
                check("zen_commit_push", a, K.zen_commit_push_unfused(
                    lp, v, cap_server=lay.cap_server, cap_pull=cap_pull),
                    what + " vs unfused chain")
                log(f"[kernels] zen_commit_push {what}: equal, and to the "
                    f"unfused chain (live rows="
                    f"{int((lp < lay.cap_server).sum())}, ovf={int(b[3])})")
            log(f"[kernels] coo_scatter_add {name} {dtype}: equal (stream, "
                f"non-zero out + EMPTY/negative/out-of-range, 64 repeats)")
        for cap_pull in caps:
            a = K.zen_commit_pull_fused_op(bms, lay.cap_server, cap_pull)
            b = R.zen_commit_pull_ref(bms, lay.cap_server, cap_pull)
            check("zen_commit_pull", [a], [b], f"{name} cap_pull={cap_pull}")
            check("zen_commit_pull", [a], [K.zen_commit_pull_unfused(
                bms, lay.cap_server, cap_pull)],
                f"{name} cap_pull={cap_pull} vs unfused chain")
        log(f"[kernels] zen_commit_pull {name}: equal, and to the unfused "
            f"chain")
        if name == "realistic":
            shapes = dict(inp, lo=lay)
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
    for fe, fc in ((False, True), (True, False), (False, False)):
        for backend in ("cuda", "torch"):
            c_out, c_st = S.simulate(S.zen_sync, g, layout=lo,
                                     backend=backend, fused=fe,
                                     fused_commit=fc)
            same([c_out, c_st.sent_words, c_st.overflow],
                 [a_out, a_st.sent_words, a_st.overflow],
                 f"zen_sync {backend} fused={fe} fused_commit={fc} vs "
                 f"fused cuda")
            del c_out
        log(f"[zen_sync] fused={fe} fused_commit={fc}: cuda and torch equal "
            f"the fused cuda route bitwise")
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
    on_path = K.path_kernels()
    for k in K.KERNELS:
        want = 8 * steps if k in on_path else 0
        if launches[k] != want:
            raise AssertionError(f"{k} launched {launches[k]} times, "
                                 f"expected {want}")
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
    torch.cuda.empty_cache()
    unf = train_unfused(steps)
    udiff = max(abs(a - b) for a, b in zip(losses, unf["losses"]))
    log(f"[trainer] unfused chain: losses={unf['losses']} max |diff| vs "
        f"fused={udiff} sparse_words={unf['words']} overflow={unf['overflow']}"
        f" tok/s={unf['tok_per_s']} step_s={unf['step_s']} launches="
        f"{unf['launches']} plain={unf['plain']}")
    log(f"[trainer] median step s after the first: fused "
        f"{np.median(res['step_s'][1:])}, plain route "
        f"{np.median(plain_res['step_s'][1:])}, unfused chain "
        f"{np.median(unf['step_s'][1:])}")
    if not all(np.isfinite(unf["losses"])) \
            or not unf["losses"][-1] < unf["losses"][0]:
        raise AssertionError(f"unfused trainer loss not finite and falling: "
                             f"{unf['losses']}")
    if max(unf["overflow"]) != 0:
        raise AssertionError(f"unfused trainer overflow {unf['overflow']}")
    if unf["words"][-1] != res["sparse_words"]:
        raise AssertionError(f"unfused sparse words {unf['words'][-1]} != "
                             f"fused {res['sparse_words']}")
    if udiff > 5e-3:
        raise AssertionError(f"unfused and fused routes diverge: {udiff}")
    on_path = K.path_kernels(**UNFUSED)
    for k in K.KERNELS:
        want = 8 * steps if k in on_path else 0
        if unf["launches"][k] != want:
            raise AssertionError(f"unfused run: {k} launched "
                                 f"{unf['launches'][k]} times, expected "
                                 f"{want}")
        if unf["plain"][k]:
            raise AssertionError(f"unfused run: {k} took the plain route "
                                 f"{unf['plain'][k]} times")
    for k in on_path:
        launches[k] = unf["launches"][k]
    return {"launches": launches, "plain_route": plain_res, "unfused": unf,
            **res}


def train_unfused(steps: int) -> dict:
    """The smoke trainer (``launch/train.py``'s flags and SyntheticLM
    batches) with ``SyncConfig(fused_encode=False, fused_commit=False)``,
    built through ``build_program`` + ``attach_train``: the launcher has
    no flag for the unfused encode, as the reference's has none."""
    from repro_torch.configs import get_config
    from repro_torch.core.zen import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops as K
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.build import attach_train, build_program
    from repro_torch.train.steps import TrainerConfig

    cfg = get_config("qwen2-0.5b")
    tcfg = TrainerConfig(opt=OptConfig(lr=3e-4),
                         sync=SyncConfig(scheme="zen", density_budget=0.25,
                                         **UNFUSED))
    prog = build_program(cfg, "8x1", tcfg, device="cuda", seed=0)
    attach_train(prog)
    data = iter(SyntheticLM(cfg, DataConfig(seq_len=512, batch=8, seed=0)))
    losses, words, ovf, step_s = [], [], [], []
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.time()
    for _ in range(steps):   # timed as launch/train.py times a logged step
        b = next(data)
        t_step = time.time()
        m = prog.train_step({k: torch.as_tensor(v, device="cuda").long()
                             for k, v in b.items()})
        torch.cuda.synchronize()
        step_s.append(time.time() - t_step)
        losses.append(float(m["loss"]))
        words.append(float(m["sync/sparse_sent_words"]))
        ovf.append(int(float(m["sync/overflow"])))
    dt = time.time() - t0
    out = {"losses": losses, "words": words, "overflow": ovf,
           "launches": dict(K.LAUNCHES), "plain": dict(K.PLAIN_CALLS),
           "tok_per_s": steps * 8 * 512 / dt, "step_s": step_s}
    del prog
    torch.cuda.empty_cache()
    return out


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


def bound(nbytes: int, nops: int = 0) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the compute rate, in ms."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_times(inp: dict, smi: str) -> list:
    from repro_torch.kernels import ops as K, ref as R

    lo, idx, lp, vals, bms, mem, mask = (inp[k] for k in (
        "lo", "idx", "lp", "vals", "bms", "mem", "mask"))
    n, L, d = lo.n, lo.cap_pull, vals.shape[1]
    W = -(-L // 32)
    live = int((lp < lo.cap_server).sum())
    touched = int(torch.unique(lp[lp < lo.cap_server]).numel())
    el = vals.element_size()
    seeds = lo.static_seeds()
    C, k = idx.numel(), len(seeds) - 1
    Ws = -(-lo.cap_server // 32)
    bits = torch.zeros(Ws * 32, dtype=torch.int32, device=mask.device)
    bits[:mask.numel()] = mask.to(torch.int32)
    words = bms.reshape(-1)
    out = torch.zeros((lo.cap_server, d), dtype=vals.dtype,
                      device=vals.device)
    keep = lp < lo.cap_server
    lib_idx, lib_vals = lp[keep].long(), vals[keep]
    # per index: k+1 hashes of 2 fmix32 rounds (8 ops each), 2 xors and a
    # modulo
    hash_ops = C * (k + 1) * 19
    rows = {
        "zen_encode": (
            lambda: K.zen_encode_fused_op(idx, seeds, n, lo.r1, lo.r2),
            lambda: R.zen_encode_ref(idx, seeds, n, lo.r1, lo.r2),
            C * 4 + n * (L + W + 1) * 4, 0, None),
        "zen_commit_push": (
            lambda: K.zen_commit_push_fused_op(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lambda: R.zen_commit_push_ref(
                lp, vals, cap_server=lo.cap_server, cap_pull=L),
            lp.numel() * 4 + live * d * el + L * (4 + d * el)
            + lo.cap_bitmap_words * 4 + 4, live * d, None),
        "zen_commit_pull": (
            lambda: K.zen_commit_pull_fused_op(bms, lo.cap_server, L),
            lambda: R.zen_commit_pull_ref(bms, lo.cap_server, L),
            bms.numel() * 4 + n * L * 4, 0, None),
        "hash_stage": (
            lambda: K.hash_stage_op(idx, seeds, n, lo.r1),
            lambda: R.hash_stage_ref(idx, seeds, n, lo.r1),
            C * 4 * (2 + k), hash_ops, None),
        "row_compact": (
            lambda: K.row_compact_op(mem),
            lambda: R.row_compact_ref(mem),
            2 * mem.numel() * 4, 0, None),
        "coo_scatter_add": (
            lambda: K.coo_scatter_add_op(out, lp, vals),
            lambda: R.coo_scatter_add_ref(out, lp, vals),
            lp.numel() * 4 + live * d * el + 2 * touched * d * el, live * d,
            lambda: out.index_add_(0, lib_idx, lib_vals)),
        "bitmap_pack": (
            lambda: K.bitmap_pack_op(mask),
            lambda: R.bitmap_pack_ref(bits),
            mask.numel() + Ws * 4, 0, None),
        "bitmap_unpack": (
            lambda: K.bitmap_unpack_op(words, words.numel() * 32),
            lambda: R.bitmap_unpack_ref(words) != 0,
            words.numel() * 4 + words.numel() * 32, 0, None),
    }
    res = []
    for name, (kern, plain, nbytes, nops, lib) in rows.items():
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        lib_ms = cuda_time_ms(lib) if lib is not None else None
        bound_ms, bound_by = bound(nbytes, nops)
        res.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "bytes": nbytes, "ops": nops})
        log(f"[times] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{lib_ms} ms, bound {bound_ms:.6f} ms by {bound_by} from "
            f"{nbytes} B / {nops} ops) | {smi}")
    return res


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
            "library_ms": row["library_ms"]})
    log(f"[done] {time.time() - t_start:.1f}s | {dev_info['smi']}")
    print(json.dumps({"kernels": table}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))


if __name__ == "__main__":
    main()
