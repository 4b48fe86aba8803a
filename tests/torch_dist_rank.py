"""One rank of a ``tests/test_torch_dist.py`` process group (CPU, gloo).

    python tests/torch_dist_rank.py DIR JOB [JOB ...]

The test starts one such process per rank with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  Each rank reads ``DIR/inputs.npz``, joins the group
through ``launch.mesh.make_data_group("gloo", "cpu")``, runs the JOBs on
its own worker's slice of the inputs and writes ``DIR/rank<r>.npz``.  It
imports only torch, numpy and ``repro_torch``: the JAX reference runs in
the test's own process.

Jobs:
  zen       ``zen_sync`` of every ``zen/<case>/vals`` on every route and
            the COO pull;
  dense     ``dense_sync`` of every ``dense/<dtype>`` stack;
  schemes   each baseline scheme (agsparse, sparcml, sparse_ps, omnireduce,
            balanced) on every ``schemes/<case>/vals``, its stage kwargs
            from ``schemes/<case>/kw/<name>``, on the ``"cuda"`` route (the
            scatter-add's plain version on the CPU);
  gradsync  a whole ``GradSync`` over the ``gs/<leaf>`` stacks, one bucket
            per leaf and with dense leaves fused into ``gs_bucket_bytes``
            buckets;
  compress  the bucketed GradSync with ``--compress topk:0.01`` (zen on
            every dense bucket's EF-sparsified payload) over the ``gs/<leaf>``
            stacks, two steps (the second on the stacks doubled), the
            residual threaded through;
  broadcast ``build_program`` from seed ``w`` on rank ``w``: every rank
            must then hold rank 0's parameters;
  trainer   the reduced qwen2 trainer on ``<n>x1`` from the reference's
            parameters, full update (``zero1=False``); on a 2-rank group
            rank 0 then runs the in-process ``SimGroup`` 2x1 trainer on the
            same inputs;
  zero1     the same trainer under ZeRO-1 (each process updating its own
            chunk of every leaf, its moments ``[1, c]``), with the bytes of
            the moments this process holds; rank 0 then runs the
            in-process ``SimGroup`` trainer under ZeRO-1 (moments ``[n,
            c]``) on the same inputs;
  hier      on a two-level topology of nodes of 2 ranks (``--node-size
            2``, the level groups made by ``launch.mesh.make_level_groups``):
            the ``gradsync`` job's two GradSyncs, then the ``trainer`` job,
            after which rank 0 runs the in-process two-level trainer on the
            same inputs;
  lint      zenlint's trace sweep (``repro_torch.analysis.lint``) on this
            rank of the group (``DistGroup``, n the group's size, M
            ``lint_m``): its findings and, per case, the bytes it recorded
            by (collective kind, group size).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import schemes as S
from repro_torch.core.topology import build_topology
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.kernels import ops as K
from repro_torch.launch.mesh import make_data_group, make_level_groups
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

# (fused, fused_commit, use_hash_bitmap) of each zen_sync variant
VARIANTS = {"fused": (True, True, True), "encode-unfused": (False, True, True),
            "commit-unfused": (True, False, True),
            "both-unfused": (False, False, True),
            "coo-pull": (True, True, False)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
STEPS = 4


def _zen(inp, w: int, group, out: dict) -> None:
    cases = sorted({k.split("/")[1] for k in inp if k.startswith("zen/")})
    for case in cases:
        vals = torch.from_numpy(inp[f"zen/{case}/vals"][w:w + 1])
        vals = vals.to(DTYPES[str(inp[f"zen/{case}/dtype"])])
        lo = S.make_zen_layout(vals.shape[1], group.n,
                               seeds=inp[f"zen/{case}/seeds"],
                               **{k: float(inp[f"zen/{case}/{k}"]) for k in
                                  ("density_budget", "r1_factor")})
        for name, (fe, fc, hb) in VARIANTS.items():
            K.reset_counts()
            res, st = S.zen_sync(vals, group=group, layout=lo, backend="cuda",
                                 fused=fe, fused_commit=fc,
                                 use_hash_bitmap=hb)
            key = f"zen/{case}/{name}"
            out[f"{key}/dtype"] = str(res.dtype)
            out[f"{key}/out"] = res.float().numpy()
            out[f"{key}/sent"] = st.sent_words.numpy()
            out[f"{key}/overflow"] = st.overflow.numpy()
            out[f"{key}/plain"] = np.array([K.PLAIN_CALLS[k]
                                            for k in K.KERNELS])


def _dense(inp, w: int, group, out: dict) -> None:
    for name, td in DTYPES.items():
        x = torch.from_numpy(inp[f"dense/{name}"][w:w + 1]).to(td)
        res, st = S.dense_sync(x, group=group)
        out[f"dense/{name}/out"] = res.float().numpy()
        out[f"dense/{name}/sent"] = st.sent_words.numpy()


def _schemes(inp, w: int, group, out: dict) -> None:
    cases = sorted({k.split("/")[1] for k in inp if k.startswith("schemes/")})
    for case in cases:
        pre = f"schemes/{case}"
        vals = torch.from_numpy(inp[f"{pre}/vals"][w:w + 1])
        vals = vals.to(DTYPES[str(inp[f"{pre}/dtype"])])
        name = str(inp[f"{pre}/name"])
        kw = {k.split("/")[-1]: int(inp[k]) for k in inp
              if k.startswith(f"{pre}/kw/")}
        K.reset_counts()
        res, st = getattr(S, f"{name}_sync")(vals, group=group,
                                              backend="cuda", **kw)
        out[f"{pre}/out"] = res.float().numpy()
        out[f"{pre}/sent"] = st.sent_words.numpy()
        out[f"{pre}/overflow"] = st.overflow.numpy()
        out[f"{pre}/plain"] = np.array(K.PLAIN_CALLS["coo_scatter_add"])


def _gradsync(inp, w: int, group, out: dict) -> None:
    names = [str(x) for x in inp["gs_names"]]
    grads = {nm: torch.from_numpy(inp[f"gs/{nm}"][w:w + 1]) for nm in names}
    for key, bucket_bytes in (("gs", None),
                              ("gsb", int(inp["gs_bucket_bytes"]))):
        gs = GradSync(SyncConfig(bucket_bytes=bucket_bytes), ["embed/table"],
                      [(nm, tuple(g.shape[1:]), g.dtype)
                       for nm, g in grads.items()],
                      group.n, group)
        rows = grads["embed/table"].shape[1]
        gs._layouts["embed/table", 0] = S.make_zen_layout(
            rows, group.n, density_budget=0.25, seeds=inp["gs_seeds"])
        synced, stats = gs(grads)
        for nm in names:
            out[f"{key}/{nm}"] = synced[nm].numpy()
        for k, v in stats.items():
            out[f"{key}_stats/{k}"] = v.float().numpy()


HIER_NODE = 2   # ranks per node of the hier job


def _hier_gradsync(inp, w: int, group, out: dict) -> None:
    names = [str(x) for x in inp["gs_names"]]
    grads = {nm: torch.from_numpy(inp[f"gs/{nm}"][w:w + 1]) for nm in names}
    topo = build_topology(group.n, HIER_NODE)
    make_level_groups(group, topo)
    for key, bucket_bytes in (("hgs", None),
                              ("hgsb", int(inp["gs_bucket_bytes"]))):
        gs = GradSync(SyncConfig(bucket_bytes=bucket_bytes), ["embed/table"],
                      [(nm, tuple(g.shape[1:]), g.dtype)
                       for nm, g in grads.items()],
                      group.n, group, topology=topo)
        synced, stats = gs(grads)
        for nm in names:
            out[f"{key}/{nm}"] = synced[nm].numpy()
        for k, v in stats.items():
            out[f"{key}_stats/{k}"] = v.float().numpy()


COMPRESS = "topk:0.01"


def _compress(inp, w: int, group, out: dict) -> None:
    names = [str(x) for x in inp["gs_names"]]
    grads = {nm: torch.from_numpy(inp[f"gs/{nm}"][w:w + 1]) for nm in names}
    gs = GradSync(SyncConfig(compress=COMPRESS,
                             bucket_bytes=int(inp["gs_bucket_bytes"])),
                  ["embed/table"], [(nm, tuple(g.shape[1:]), g.dtype)
                                    for nm, g in grads.items()],
                  group.n, group)
    res = gs.init_residual("cpu")
    for step in range(2):
        synced, res, stats = gs({nm: g * (1 + step)
                                 for nm, g in grads.items()}, res, step=step)
        for nm in names:
            out[f"cgs/{step}/{nm}"] = synced[nm].numpy()
        for k, v in res.items():
            out[f"cgs/{step}/res/{k}"] = v.numpy()
        for k, v in stats.items():
            out[f"cgs/{step}/stats/{k}"] = v.float().numpy()


def _broadcast(inp, w: int, group, out: dict) -> None:
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    prog = build_program(cfg, f"{group.n}x1", device="cpu", seed=w,
                         group=group)
    out["broadcast"] = torch.cat([p.detach().reshape(-1) for p in
                                  prog.model.parameters()]).numpy()


def _reference_tree(inp) -> dict:
    """The reference's parameter pytree from its '/'-joined npz keys."""
    tree: dict = {}
    for key in inp:
        if key.startswith("params/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = inp[key]
    return tree


def _train(inp, group, out: dict, prefix: str, node_size: int = 1,
           zero1: bool = False) -> None:
    """STEPS steps of the reduced f32 qwen2 trainer on ``group`` (None:
    the in-process SimGroup) from the reference's parameters, the full
    update or ``zero1``."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    n = int(inp["n"])
    prog = build_program(cfg, f"{n}x1",
                         TrainerConfig(sync=SyncConfig(scheme="zen"),
                                       zero1=zero1),
                         device="cpu", group=group, node_size=node_size)
    prog.model.load_reference_params(_reference_tree(inp))
    attach_train(prog)
    batch = {k: torch.from_numpy(inp[f"batch/{k}"]).long()
             for k in ("tokens", "labels")}
    K.reset_counts()
    metrics = [prog.train_step(batch) for _ in range(STEPS)]
    for k in ("loss", "sync/overflow", "sync/sparse_sent_words"):
        out[f"{prefix}/{k}"] = np.array([float(m[k]) for m in metrics])
    out[f"{prefix}/plain"] = np.array([K.PLAIN_CALLS[k] for k in K.KERNELS])
    out[f"{prefix}/launches"] = np.array([K.LAUNCHES[k] for k in K.KERNELS])
    out[f"{prefix}/embed"] = prog.model.embed.table.detach().numpy()
    out[f"{prefix}/params"] = torch.cat([p.detach().reshape(-1) for p in
                                         prog.model.parameters()]).numpy()
    moments = [m for st in prog.opt_state()["leaves"].values()
               for m in st.values()]
    out[f"{prefix}/moment_bytes"] = np.array(
        sum(m.numel() * m.element_size() for m in moments))
    out[f"{prefix}/moment_rows"] = np.array(sorted({m.shape[0]
                                                    for m in moments}))


def _lint(inp: dict, w: int, group, out: dict) -> None:
    from repro_torch.analysis.lint import run_trace_sweep
    findings, wires = run_trace_sweep(ns=(group.n,), M=int(inp["lint_m"]),
                                      verbose=False, device="cpu",
                                      group=group)
    out["lint/findings"] = np.array([str(f) for f in findings] or [""])
    rows = [(f"{label}|{kind}|{g}", b) for label, wire in wires.items()
            for (kind, g), b in wire.items()]
    out["lint/keys"] = np.array([k for k, _ in rows])
    out["lint/bytes"] = np.array([b for _, b in rows])


def main(work: Path, jobs: list[str]) -> None:
    torch.set_num_threads(1)
    inp = dict(np.load(work / "inputs.npz"))
    out: dict = {}
    group, _ = make_data_group("gloo", "cpu")
    try:
        w = group.ranks[0]
        for job, fn in (("zen", _zen), ("dense", _dense),
                        ("schemes", _schemes),
                        ("gradsync", _gradsync), ("compress", _compress),
                        ("broadcast", _broadcast), ("lint", _lint)):
            if job in jobs:
                fn(inp, w, group, out)
        if "trainer" in jobs:
            _train(inp, group, out, "trainer")
        if "zero1" in jobs:
            _train(inp, group, out, "zero1", zero1=True)
        if "hier" in jobs:
            _hier_gradsync(inp, w, group, out)
            _train(inp, group, out, "htrainer", node_size=HIER_NODE)
    finally:
        dist.destroy_process_group()
    if "trainer" in jobs and group.n == 2 and w == 0:
        _train(inp, None, out, "simgroup")
    if "zero1" in jobs and w == 0:
        _train(inp, None, out, "zsim", zero1=True)
    if "hier" in jobs and w == 0:
        _train(inp, None, out, "hsim", node_size=HIER_NODE)
    np.savez(work / f"rank{os.environ['RANK']}.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2:])
