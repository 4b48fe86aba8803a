"""Dry run at the production meshes: one rank's step on the meta device
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference forces 512 host devices and lowers and compiles each
(architecture, input shape, mesh) for XLA's cost and memory analyses.
The port runs rank 0 of a fake world of P x D x M ranks
(``launch/mesh.fake_world``, torch's ``"fake"`` backend: every collective
returns at once) on the meta device: the program is built with
``build_program(..., device="meta")`` (shapes, no values: nothing is
allocated, no card is needed), its groups with ``launch/mesh``, and the
train, prefill or decode step runs once on the shapes of the global
batch under ``launch/trace_cost.CostMode``.  The
kernel wrappers return their outputs' shapes on meta and log their cost
(``kernels/ops.kernel_cost``).

Each record has the reference's keys but ``lower_s`` / ``compile_s``
(here ``build_s`` / ``trace_s``) and ``xla_*`` (here
``torch_flops_per_device``, the walk's matmul and convolution FLOPs,
``trace_cost.matmul_flops``); ``memory``
holds the argument bytes (this rank's parameters, the optimizer state,
the trainer's gradient stacks and Zen tables, and its batch or decode
cache), the
output bytes (new buffers the step returns), the peak (arguments plus the
most new bytes alive at once) and the temp bytes (peak minus arguments).
``kernel_calls`` counts the kernel wrapper calls by kernel.

For the serve shapes each rank takes its rows of the global batch as the
reference's ``batch_pspecs`` does: the batch sharded over P x D when that
divides it, replicated otherwise (``long_500k``'s one sequence).  The
train step takes the global batch and each rank its rows (``split_batch``).
``--fused-attn`` drops ``flash_fwd``'s score bytes (what its plain
version would materialize) from ``bytes_per_device``.  A combination the
port refuses (``make_ctx``'s divisibility checks, a kernel's domain)
writes its error instead of a record.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.core.registry import cli_scheme_choices
from repro_torch.core.topology import build_topology
from repro_torch.core.zen import SyncConfig
from repro_torch.launch.mesh import (fake_world, make_level_groups,
                                     mesh_groups, production_mesh)
from repro_torch.launch.trace_cost import CostMode, analyze, matmul_flops
from repro_torch.models.common import ArchConfig
from repro_torch.train.build import (Program, attach_serve, attach_train,
                                     build_program)
from repro_torch.train.steps import TrainerConfig


def join_mesh(world, pods: int, dp: int, tp: int, node_size: int = 1):
    """``(data group, model group or None)`` of this rank of the joined
    ``world`` laid out as ``PxDxM`` (``launch/mesh.mesh_groups``; at M = 1
    the world is the data group, its level groups made)."""
    if tp > 1:
        return mesh_groups(world, tp, pods, node_size)
    make_level_groups(world, build_topology(dp, node_size), pods)
    return world, None


def _storages(tree) -> dict[int, int]:
    """{storage id: bytes} of the tensors in ``tree``."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def serve_rows(global_batch: int, ndata: int) -> int:
    """A data rank's sequences of a serve batch: sharded over the P x D
    data ranks when they divide it, else the whole batch on every rank."""
    return global_batch // ndata if global_batch % ndata == 0 \
        else global_batch


def _inputs(cfg: ArchConfig, rows: int, seq: int, device) -> dict:
    """A batch's shapes: int64 tokens [rows, seq], and an encoder-decoder's
    f32 ``frames`` or a VLM's f32 ``patches``."""
    batch = {"tokens": torch.zeros((rows, seq), dtype=torch.long,
                                   device=device)}
    if cfg.kind == "enc_dec":
        batch["frames"] = torch.zeros((rows, cfg.enc_len, cfg.d_model),
                                      dtype=torch.float32, device=device)
    if cfg.kind == "vlm":
        batch["patches"] = torch.zeros((rows, cfg.n_patches, cfg.d_model),
                                       dtype=torch.float32, device=device)
    return batch


def trace_step(prog: Program, spec: dict, fused_attn: bool = False,
               ready=None, warmup: int = 0) -> dict:
    """Attach ``spec``'s step (``mode``: train, prefill or decode, at
    ``seq_len`` and ``global_batch``) to ``prog`` and run it once under
    ``CostMode``, on the program's device: the walked cost, its matmul
    FLOPs, the memory and the kernel
    calls.  ``warmup`` steps run first, untraced (on the card: the kernels'
    kept scratch and the libraries' workspaces made before the baseline);
    ``ready()``, when given, runs after them, just before the traced step
    (the card's baseline)."""
    mode, S, B = spec["mode"], spec["seq_len"], spec["global_batch"]
    dev, cfg = prog.device, prog.cfg
    t0 = time.time()
    if mode == "train":
        attach_train(prog)
        batch = _inputs(cfg, B, S, dev)
        batch["labels"] = batch["tokens"]
        rows = B // prog.group.n if B % prog.group.n == 0 else B
        # the Zen layouts' tables are offline state, uploaded before the
        # step as the card's first sync would (a meta or CUDA copy, none
        # on the CPU)
        pdev = next(prog.model.parameters()).device
        args = (prog.train_step.state, prog.train_step.stacks,
                prog.gradsync.upload_tables(pdev))
        batch_bytes = sum(v[:rows].numel() * v.element_size()
                          for v in batch.values())

        def step():
            return prog.train_step(batch)
    else:
        rows = serve_rows(B, prog.group.n)
        attach_serve(prog, S, rows, mode)
        if mode == "prefill":
            batch = _inputs(cfg, rows, S, dev)
            args = (batch,)

            def step():
                return prog.prefill_step(batch)
        else:
            cache = prog.fresh_cache()
            tok = torch.zeros((rows, 1), dtype=torch.long, device=dev)
            args = (cache, tok)

            def step():
                return prog.decode_step(cache, tok)
        batch_bytes = 0
    for _ in range(warmup):
        step()
    # the layers' recompute (torch.utils.checkpoint) sets itself up at its
    # first call, an import that keeps the caller's frames (and their
    # tensors) in reference cycles until a collection: one call here
    # keeps that out of the traced step, whose frees then follow the
    # step's own references on every device
    checkpoint(torch.neg, torch.zeros(()), use_reentrant=False)
    arg = _storages((list(prog.model.parameters()), args))
    arg_bytes = sum(arg.values()) + batch_bytes
    if ready is not None:
        ready()
    attach_s = time.time() - t0
    t0 = time.time()
    with CostMode() as cm:
        out = step()
    trace_s = time.time() - t0
    walked = analyze(cm, exclude="flash_fusable" if fused_attn else None)
    out_bytes = sum(n for k, n in _storages(out).items() if k not in arg)
    calls: dict[str, int] = {}
    for r in cm.records:
        if r.op.startswith("kernel:"):
            calls[r.op[7:]] = calls.get(r.op[7:], 0) + 1
    return {"attach_s": attach_s, "trace_s": trace_s, "walked": walked,
            "torch_flops": matmul_flops(cm),
            "kernel_calls": dict(sorted(calls.items())),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": cm.peak,
                       "peak_bytes": arg_bytes + cm.peak},
            "records": cm.records}


def build_on(cfg: ArchConfig, mesh: tuple[int, int, int], world, tcfg,
             device, node_size: int = 1, pad_heads: bool = False,
             moe_a2a: bool = False) -> Program:
    """``cfg``'s program (its kernels' route) for this rank of the joined
    ``world`` laid out as ``mesh`` = (P, D, M)."""
    pods, dp, tp = mesh
    group, mgroup = join_mesh(world, pods, dp, tp, node_size)
    return build_program(cfg, f"{pods}x{dp}x{tp}", tcfg, device=device,
                         group=group, node_size=node_size,
                         model_group=mgroup, pad_heads=pad_heads,
                         moe_a2a=moe_a2a)


def dryrun_combo(arch: str, shape: str, multi_pod: bool,
                 sync_scheme: str = "zen", pad_heads: bool = False,
                 fused_attn: bool = False, moe_a2a: bool = False,
                 bucket_bytes: int | None = None,
                 compress: str = "none", node_size: int = 1,
                 alpha_beta: str | None = None,
                 calib_file: str | None = None, *,
                 cfg: ArchConfig | None = None, spec: dict | None = None,
                 mesh: tuple[int, int, int] | None = None) -> dict:
    """Trace one (arch, input shape, mesh) combination: rank 0 of the
    production mesh (``launch/mesh.production_mesh``) in a fake world, on
    the meta device.  ``cfg`` / ``spec`` / ``mesh`` override the config,
    the input shape and the mesh (tests and the card's check only)."""
    cfg = cfg or get_config(arch)
    spec = spec or INPUT_SHAPES[shape]
    pods, dp, tp = mesh or production_mesh(multi_pod, node_size)
    tcfg = TrainerConfig(sync=SyncConfig(
        scheme=sync_scheme, bucket_bytes=bucket_bytes, compress=compress,
        alpha_beta=alpha_beta, calib_file=calib_file))
    with fake_world(pods * dp * tp) as world:
        t0 = time.time()
        prog = build_on(cfg, (pods, dp, tp), world, tcfg, "meta",
                        node_size, pad_heads, moe_a2a)
        build_s = time.time() - t0
        res = trace_step(prog, spec, fused_attn)
        del prog
    mode = spec["mode"]
    walked = res["walked"]
    return {
        "arch": arch, "shape": shape,
        "mesh": f"{pods}x{dp}x{tp}" if pods > 1 else f"{dp}x{tp}",
        "mode": mode,
        "build_s": round(build_s + res["attach_s"], 1),
        "trace_s": round(res["trace_s"], 1),
        "flops_per_device": float(walked["flops"]),
        "bytes_per_device": float(walked["bytes"]),
        "torch_flops_per_device": res["torch_flops"],
        "collectives": walked["collectives"],
        "collective_bytes_total": int(walked["collective_bytes_total"]),
        "memory": res["memory"],
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens_per_step": spec["global_batch"] * (
            1 if mode == "decode" else spec["seq_len"]),
        "kernel_calls": res["kernel_calls"],
    }


HBM_BYTES = 80 * 10**9   # one H100's device memory


def summary(outdir: Path, archs, shapes) -> list[str]:
    """A markdown table of the records in ``outdir``: a row per (arch,
    mesh), a column per shape, each cell a device's TFLOP, HBM TB,
    collective GB and peak GiB, and whether the peak fits one H100's
    80 GB (or the record's error)."""
    rows = ["| arch | mesh | " + " | ".join(shapes) + " |",
            "|---|---|" + "---|" * len(shapes)]
    for arch in archs:
        for tag, mesh in (("sp", "16x16"), ("mp", "2x16x16")):
            cells = []
            for shape in shapes:
                fp = outdir / f"{arch}__{shape}__{tag}.json"
                r = json.loads(fp.read_text()) if fp.exists() \
                    else {"error": "no record"}
                if "error" in r:
                    cells.append(r["error"][:60])
                    continue
                peak = r["memory"]["peak_bytes"]
                cells.append(
                    f"{r['flops_per_device'] / 1e12:.3g} / "
                    f"{r['bytes_per_device'] / 1e12:.3g} / "
                    f"{r['collective_bytes_total'] / 1e9:.3g} / "
                    f"{peak / 2**30:.3g} "
                    + ("fits" if peak <= HBM_BYTES else "**no**"))
            rows.append(f"| {arch} | {mesh} | " + " | ".join(cells) + " |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run on the meta "
                                             "device")
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) combos on both meshes")
    ap.add_argument("--sync", default="zen", choices=cli_scheme_choices())
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="fuse dense grads into buckets of at most this "
                         "many bytes (the bucketed overlap schedule); "
                         "default: a bucket a leaf")
    ap.add_argument("--compress", default="none",
                    help="EF-sparsify dense buckets before sync, e.g. "
                         "'topk:0.01'; default: none")
    ap.add_argument("--node-size", type=int, default=1,
                    help="data ranks a node: the two-level sync")
    ap.add_argument("--alpha-beta", default=None,
                    help="α-β link override for the topology cost model "
                         "('a_intra,b_intra,a_inter,b_inter' in µs, "
                         "µs/word)")
    ap.add_argument("--calib-file", default=None,
                    help="measured-time calibration table for the plan "
                         "choice; must exist (python -m "
                         "repro_torch.core.costmodel --calib-file PATH)")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad the q heads to a multiple of M and shard them")
    ap.add_argument("--fused-attn", action="store_true",
                    help="count flash_fwd's scores as kept on chip (the "
                         "kernel's), not materialized (its plain version)")
    ap.add_argument("--moe-a2a", action="store_true",
                    help="MoE: the token-sharded all-to-all dispatch")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ALL_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                fp = outdir / f"{tag}.json"
                if args.skip_existing and fp.exists():
                    if "error" not in json.loads(fp.read_text()):
                        continue
                try:
                    rec = dryrun_combo(arch, shape, mp, args.sync,
                                       pad_heads=args.pad_heads,
                                       fused_attn=args.fused_attn,
                                       moe_a2a=args.moe_a2a,
                                       bucket_bytes=args.bucket_bytes,
                                       compress=args.compress,
                                       node_size=args.node_size,
                                       alpha_beta=args.alpha_beta,
                                       calib_file=args.calib_file)
                    fp.write_text(json.dumps(rec, indent=1))
                    print(f"OK   {tag}: trace={rec['trace_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll={rec['collective_bytes_total']:.3e}B "
                          f"peak={rec['memory']['peak_bytes'] / 2**30:.1f}"
                          f"GiB", flush=True)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc(limit=4)
                    fp.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mp,
                         "error": f"{type(e).__name__}: {e}"}))
                    print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:200]}",
                          flush=True)
                    n_fail += 1
                gc.collect()
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if len(meshes) == 2:
        print("\n".join(summary(outdir, archs, shapes)))
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
