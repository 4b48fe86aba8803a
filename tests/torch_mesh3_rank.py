"""One rank of the 8-process gloo world of ``tests/test_torch_mesh3.py``
(CPU).

    python tests/torch_mesh3_rank.py DIR

The test starts eight such processes with torchrun's environment.  Each
reads ``DIR/inputs.npz`` (for each config under ``<arch>/``: the
reference's global f32 parameters of its reduced config under
``params/``, the batch; the reference's Zen hash seeds; the prompt) and
joins the world once (``launch.mesh.make_data_group``).  It then lays the
world out anew, through new groups (``launch.mesh.mesh_groups``), as
``2x2x2``, as ``4x2`` on nodes of 2 and as the flat ``4x2`` (the
control), and at each runs the jobs below, writing ``DIR/rank<r>.npz``.
It imports only torch, numpy and ``repro_torch``: the JAX reference runs
in the test's processes.

Per config and layout (``<arch>/<layout>/...``):
  shard     this rank's leaves after ``load_reference_params``;
  synced    step 0's gradient of this rank's rows, synced by GradSync
            (Zen on the table shard at each level, the pods' mean);
  trainer   4 AdamW steps with Zen (the reference's hash seeds at every
            level) under ZeRO-1: the losses, this rank's ``sync/*`` words
            and overflow each step; the parameters after 2 steps bitwise
            those of 2 steps of the full update (``zero1_bitwise``);
  ckpt      (``4x2n2``) the ``2x2x2`` trainer's final parameters, saved
            gathered by rank 0, loaded into a fresh ``4x2`` build: this
            rank's leaves bitwise the ``2x2x2`` run's.
and, for qwen2-0.5b, the servers: ranks 0-3 a ``2x2`` mesh, ranks 4-5 a
``1x2`` one (ranks 6-7 idle), each through ``launch.serve.serve`` on the
seed-0 weights in f32, and the ``2x2`` prefill on the reference's
parameters (the last-position logits gathered over the data group).
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io
from repro_torch.core.schemes import (DistGroup, level_budget,
                                      make_zen_layout)
from repro_torch.core.zen import SyncConfig
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_data_group, mesh_groups
from repro_torch.train.build import (attach_serve, attach_train,
                                     build_program, parse_mesh)
from repro_torch.train.steps import TrainerConfig, split_batch
from torch_tp_rank import cfg_of, reference_tree, torch_inputs

TP, STEPS = 2, 4
# tag: (mesh, node size)
LAYOUTS = {"2x2x2": ("2x2x2", 1), "4x2n2": ("4x2", 2), "4x2": ("4x2", 1)}
SERVE_ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--dtype", "float32",
              "--batch", "4", "--prompt-len", "16", "--gen", "8",
              "--device", "cpu", "--dist", "gloo"]


class Layout:
    """One layout of the world: its groups and builders."""

    def __init__(self, world: DistGroup, inp: dict, tag: str):
        self.inp, self.tag = inp, tag
        self.mesh, self.node_size = LAYOUTS[tag]
        self.group, self.mgroup = mesh_groups(
            world, TP, parse_mesh(self.mesh)[0], self.node_size)
        self.cfg = cfg_of(inp)
        self.a2a = self.cfg.kind == "moe"
        self.batch = torch_inputs(inp, "batch/")

    def program(self, tcfg=None, *, reference=True, seed=0):
        prog = build_program(self.cfg, self.mesh, tcfg, device="cpu",
                             seed=seed, group=self.group,
                             model_group=self.mgroup,
                             node_size=self.node_size, moe_a2a=self.a2a)
        if reference:
            prog.model.load_reference_params(reference_tree(self.inp))
        return prog

    def trainer(self, zero1: bool = True, **kw):
        prog = self.program(TrainerConfig(sync=SyncConfig(scheme="zen"),
                                          zero1=zero1), **kw)
        attach_train(prog)
        gs = prog.gradsync
        for (key, level), lo in list(gs._layouts.items()):
            # the reference's hash seeds at every level
            gs._layouts[key, level] = make_zen_layout(
                lo.length, lo.n, seeds=self.inp["zen_seeds"],
                density_budget=level_budget(gs.topology, 0.25, level))
        return prog


def leaves_of(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_leaves()}


def job_synced(lay: Layout, out: dict, pre: str) -> None:
    prog = lay.trainer()
    rows = split_batch(lay.batch, lay.group.n)[lay.group.ranks[0]]
    loss, _ = prog.model.train_loss(rows["tokens"], rows["labels"])
    loss.backward()
    stacks = {n: (torch.zeros_like(p) if p.grad is None else p.grad)[None]
              for n, p in prog.model.named_leaves()}
    synced, _ = prog.gradsync(stacks)
    for name, g in synced.items():
        out[f"{pre}/synced/{name}"] = g[0].float().numpy()


def job_trainer(lay: Layout, out: dict, pre: str) -> dict:
    """The ZeRO-1 trainer's rows; its final leaves."""
    prog = lay.trainer()
    keys = ("sync/sparse_sent_words", "sync/intra_words", "sync/inter_words",
            "sync/overflow")
    rows: dict = {"loss": []}
    at2 = None
    for step in range(STEPS):
        m = prog.train_step(lay.batch)
        rows["loss"].append(float(m["loss"]))
        for k in keys:
            if k in prog.train_step.rank_metrics:
                rows.setdefault(k, []).append(
                    float(prog.train_step.rank_metrics[k]))
        if step == 1:
            at2 = leaves_of(prog.model)
    for k, v in rows.items():
        out[f"{pre}/trainer/{k}"] = np.array(v)
    full = lay.trainer(zero1=False)
    for _ in range(2):
        full.train_step(lay.batch)
    out[f"{pre}/zero1_bitwise"] = np.array(all(
        torch.equal(p.view(torch.int32), at2[n].view(torch.int32))
        for n, p in full.model.named_leaves()))
    return {"leaves": leaves_of(prog.model),
            "gathered": io.gather_params(prog.model)}


def job_ckpt(lay: Layout, out: dict, pre: str, saved: dict,
             work: Path) -> None:
    path = work / f"ck_{lay.cfg.name}"
    if dist.get_rank() == 0:
        io.save(path, {"params": saved["gathered"]})
    dist.barrier()
    fresh = lay.program(reference=False, seed=1)
    io.load_params(fresh.model, io.restore(path, device="cpu")["params"])
    out[f"{pre}/ckpt_bitwise"] = np.array(all(
        torch.equal(p.view(torch.int32), saved["leaves"][n].view(torch.int32))
        for n, p in fresh.model.named_leaves()))


def server_groups(rank: int):
    """Ranks 0-3: a 2x2 mesh (rank w M + m); ranks 4-5: a 1x2 one.
    Every rank makes every group in one order."""
    mine: dict = {}
    for kind, members in (("model", [0, 1]), ("model", [2, 3]),
                          ("data", [0, 2]), ("data", [1, 3]),
                          ("model", [4, 5])):
        pg = dist.new_group(members)
        if rank in members:
            mine[kind] = DistGroup(pg)
    return mine.get("data"), mine.get("model")


def job_serve(inp: dict, out: dict, pre: str) -> None:
    rank = dist.get_rank()
    group, mgroup = server_groups(rank)
    if rank >= 6:
        return
    mesh = "2x2" if rank < 4 else "1x2"
    res = serve.serve(serve.parse_args([*SERVE_ARGS, "--mesh", mesh]),
                      group, mgroup, "cpu")
    out[f"{pre}/serve{mesh}/tokens"] = res["tokens"]
    out[f"{pre}/serve{mesh}/logits"] = res["prefill_logits"].numpy()
    out[f"{pre}/serve{mesh}/rows"] = np.array(res["rows"])
    if rank >= 4:
        return
    # the 2x2 prefill on the reference's parameters
    cfg = cfg_of(inp)
    prog = build_program(cfg, "2x2", device="cpu", group=group,
                         model_group=mgroup)
    prog.model.load_reference_params(reference_tree(inp))
    prompt = torch_inputs(inp, "serve/")["tokens"]
    lo, hi = res["rows"]
    attach_serve(prog, seq_len=prompt.shape[1], global_batch=hi - lo,
                 mode="prefill")
    logits, _ = prog.prefill_step({"tokens": prompt[lo:hi]})
    lf = prog.model.gather_vocab(logits).float()
    out[f"{pre}/ref_params_logits"] = group.all_gather(lf[None]).flatten(
        0, 1).numpy()


def main(work: Path) -> None:
    torch.set_num_threads(1)
    inp = dict(np.load(work / "inputs.npz"))
    world, _ = make_data_group("gloo", "cpu")
    out: dict = {}
    try:
        for arch in (str(a) for a in inp["archs"]):
            sub = {k[len(arch) + 1:]: v for k, v in inp.items()
                   if k.startswith(arch + "/")}
            saved = None
            for tag in LAYOUTS:
                lay = Layout(world, sub, tag)
                pre = f"{arch}/{tag}"
                job_synced(lay, out, pre)
                if tag == "4x2":   # the control: its synced gradient only
                    continue
                for name, p in lay.program().model.named_leaves():
                    out[f"{pre}/shard/{name}"] = p.detach().numpy()
                kept = job_trainer(lay, out, pre)
                if tag == "2x2x2":
                    saved = kept
                else:
                    job_ckpt(lay, out, pre, saved, work)
            if arch == "qwen2-0.5b":
                job_serve(sub, out, arch)
    finally:
        dist.destroy_process_group()
    np.savez(work / f"rank{os.environ['RANK']}.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
