"""One rank of a tensor-parallel process group of ``tests/test_torch_tp.py``
or ``tests/test_torch_tp_moe.py`` (CPU, gloo).

    python tests/torch_tp_rank.py DIR JOB [JOB ...]

The test starts one such process per rank with torchrun's environment.
Each rank reads ``DIR/inputs.npz`` (the reference's global f32 parameters
of ``inputs["arch"]``'s reduced config under ``params/``, a batch, a
prompt and the reference's Zen hash seeds), joins the mesh ``DxM`` with M
= 2 and D = the process count / 2 through
``launch.mesh.make_mesh_groups("gloo", 2, "cpu")``, runs the JOBs and
writes ``DIR/rank<r>.npz``.  It imports only torch, numpy and
``repro_torch``: the JAX reference runs in the test's processes.

Jobs:
  weights  a build from seed 0, gathered (``checkpoint.io.gather_params``);
  grads    the step-0 loss and every leaf's gradient over the whole batch,
           gathered to its global shape (both MoE dispatches for an MoE
           config);
  sgd      2 SGD steps without a clip: the losses;
  trainer  4 AdamW steps with Zen (the reference's hash seeds) under
           ZeRO-1 and under the full update: losses, grad norms, this
           model rank's ``sync/*`` words and overflow each step, the
           gathered parameters and the moments' bytes;
  ckpt     2 steps, and 1 step saved (rank 0 writes the gathered
           checkpoint), restored into a fresh trainer and stepped once:
           the losses and parameters of both;
  moe      2 AdamW steps, dense sync, of each MoE dispatch: losses and
           ``moe/*`` stats;
  serve    prefill of the prompt (this rank's cache share of every layer,
           the gathered last-position logits), then 7 greedy decode steps
           from the handed-off cache: 8 tokens; again with the decode cache
           whole on every rank (``decode_seq_shard`` off).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io
from repro_torch.configs import get_config
from repro_torch.core.schemes import DistGroup, make_zen_layout
from repro_torch.core.zen import SyncConfig
from repro_torch.launch.mesh import make_mesh_groups
from repro_torch.launch.serve import handoff
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import steps as st
from repro_torch.train.build import attach_serve, attach_train, build_program
from repro_torch.train.steps import TrainerConfig

TP = 2
STEPS = 4
GEN = 8


def cfg_of(inp):
    cfg = dataclasses.replace(get_config(str(inp["arch"])).reduced(),
                              dtype=torch.float32)
    if cfg.kind == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    return cfg


def reference_tree(inp) -> dict:
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


class Rank:
    def __init__(self, inp: dict):
        self.inp = inp
        self.cfg = cfg_of(inp)
        self.group, self.mgroup, _ = make_mesh_groups("gloo", TP, "cpu")
        self.world = DistGroup()
        self.mesh = f"{self.group.n}x{TP}"
        self.batch = {k: torch.from_numpy(inp[f"batch/{k}"]).long()
                      for k in ("tokens", "labels")}

    def program(self, tcfg=None, *, seed=0, reference=True, **kw):
        prog = build_program(self.cfg, self.mesh, tcfg, device="cpu",
                             seed=seed, group=self.group,
                             model_group=self.mgroup, **kw)
        if reference:
            prog.model.load_reference_params(reference_tree(self.inp))
        return prog

    def trainer(self, tcfg: TrainerConfig, **kw):
        prog = self.program(tcfg, **kw)
        attach_train(prog)
        if "zen_seeds" in self.inp:   # the reference's hash seeds
            rows = prog.model.embed.table.shape[0]
            prog.gradsync._layouts["embed/table", 0] = make_zen_layout(
                rows, self.group.n, density_budget=0.25,
                seeds=self.inp["zen_seeds"])
        return prog

    def gathered(self, model, grads: bool = False) -> dict:
        """Every leaf (or its gradient) gathered to its global shape."""
        if not grads:
            return {k: v.detach().numpy()
                    for k, v in io.gather_params(model).items()}
        dims = model.shard_dims()
        out = {}
        for name, p in model.named_leaves():
            g, dim = p.grad, dims[name]
            if dim is not None:
                g = model.ctx.all_gather_tp(g.movedim(dim, 0)).movedim(0, dim)
            out[name] = g.numpy()
        return out


def job_weights(r: Rank, out: dict) -> None:
    for name, a in r.gathered(r.program(reference=False).model).items():
        out[f"seed0/{name}"] = a


def job_grads(r: Rank, out: dict) -> None:
    for a2a in ((False, True) if r.cfg.kind == "moe" else (False,)):
        model = r.program(moe_a2a=a2a).model
        loss = model(r.batch["tokens"], r.batch["labels"])
        loss.backward()
        out[f"grads/{int(a2a)}/loss"] = np.array(loss.item())
        for name, g in r.gathered(model, grads=True).items():
            out[f"grads/{int(a2a)}/{name}"] = g


def job_sgd(r: Rank, out: dict) -> None:
    prog = r.trainer(TrainerConfig(opt=OptConfig(kind="sgd", lr=0.1,
                                                 grad_clip=0.0)))
    out["sgd/losses"] = np.array([float(prog.train_step(r.batch)["loss"])
                                  for _ in range(2)])


def job_trainer(r: Rank, out: dict) -> None:
    params = {}
    for zero1 in (True, False):
        prog = r.trainer(TrainerConfig(sync=SyncConfig(scheme="zen"),
                                       zero1=zero1))
        pre = f"trainer/{int(zero1)}"
        rows = {k: [] for k in ("loss", "grad_norm", "sync/sparse_sent_words",
                                "sync/overflow", "rank_words",
                                "rank_overflow")}
        for _ in range(STEPS):
            m = prog.train_step(r.batch)
            for k in ("loss", "grad_norm", "sync/sparse_sent_words",
                      "sync/overflow"):
                rows[k].append(float(m[k]))
            mine = prog.train_step.rank_metrics
            rows["rank_words"].append(float(mine["sync/sparse_sent_words"]))
            rows["rank_overflow"].append(float(mine["sync/overflow"]))
        for k, v in rows.items():
            out[f"{pre}/{k}"] = np.array(v)
        params[zero1] = {n: p.detach().clone()
                         for n, p in prog.model.named_leaves()}
        out[f"{pre}/moment_bytes"] = np.array(sum(
            m.numel() * m.element_size()
            for s in prog.opt_state()["leaves"].values() for m in s.values()))
        out[f"{pre}/local_numel"] = np.array(sum(
            p.numel() for _, p in prog.model.named_leaves()))
        if zero1:
            for name, a in r.gathered(prog.model).items():
                out[f"{pre}/params/{name}"] = a
    out["trainer/zero1_bitwise"] = np.array(all(
        torch.equal(params[True][n].view(torch.int32),
                    params[False][n].view(torch.int32))
        for n in params[True]))


def job_ckpt(r: Rank, out: dict, work: Path) -> None:
    tcfg = TrainerConfig(sync=SyncConfig(scheme="zen"))
    full = r.trainer(tcfg)
    want = [float(full.train_step(r.batch)["loss"]) for _ in range(2)]
    part = r.trainer(tcfg)
    part.train_step(r.batch)
    tree = {"params": io.gather_params(part.model),
            "opt": io.gather_state(part.opt_state(), r.world)}
    if r.world.ranks[0] == 0:
        io.save(work / "ck", tree)
    dist.barrier()
    back = io.restore(work / "ck", device="cpu")
    fresh = r.trainer(tcfg, seed=1, reference=False)
    io.load_params(fresh.model, back["params"])
    io.scatter_state(fresh.opt_state(), back["opt"], r.world)
    got = float(fresh.train_step(r.batch)["loss"])
    out["ckpt/losses"] = np.array([want[1], got])
    out["ckpt/params_bitwise"] = np.array(all(
        torch.equal(p.view(torch.int32), q.view(torch.int32))
        for (_, p), (_, q) in zip(fresh.model.named_leaves(),
                                  full.model.named_leaves())))


def job_moe(r: Rank, out: dict) -> None:
    for a2a in (False, True):
        prog = r.trainer(TrainerConfig(sync=SyncConfig(scheme="dense")),
                         moe_a2a=a2a)
        ms = [prog.train_step(r.batch) for _ in range(2)]
        for k in ("loss", "moe/aux_loss", "moe/dropped", "moe/skew"):
            out[f"moe/{int(a2a)}/{k}"] = np.array([float(m[k]) for m in ms])


def job_serve(r: Rank, out: dict) -> None:
    for whole in (False, True):
        prog = r.program()
        if whole:   # the decode cache whole on every rank
            ctx = dataclasses.replace(prog.model.ctx, decode_seq_shard=False)
            prog.model = Model(r.cfg, device="cpu", ctx=ctx)
            prog.model.load_reference_params(reference_tree(r.inp))
        pre = "serve" + ("_whole" if whole else "")
        tokens = torch.from_numpy(r.inp["serve/tokens"]).long()
        B, S = tokens.shape
        attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
        logits, cache = prog.prefill_step({"tokens": tokens})
        for i, c in enumerate(cache["layers"]):
            for k, v in c.items():
                out[f"{pre}/cache/{i}/{k}"] = v.numpy()
        lf = prog.model.gather_vocab(logits).float()
        out[f"{pre}/logits"] = lf.numpy()
        attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
        decode = st.make_decode_step(prog.model, prog.cache_specs["window"])
        cache = handoff(prog, cache)
        tok, toks = lf.argmax(-1)[:, None], []
        for _ in range(GEN - 1):
            toks.append(tok)
            tok, _, cache = decode(cache, tok)
        toks.append(tok)
        out[f"{pre}/tokens"] = torch.cat(toks, 1).numpy()
        out[f"{pre}/pos"] = cache["layers"][0]["pos"].numpy()


def main(work: Path, jobs: list[str]) -> None:
    torch.set_num_threads(1)
    inp = dict(np.load(work / "inputs.npz"))
    out: dict = {}
    r = Rank(inp)
    try:
        for job in jobs:
            if job == "ckpt":
                job_ckpt(r, out, work)
            else:
                globals()[f"job_{job}"](r, out)
    finally:
        dist.destroy_process_group()
    np.savez(work / f"rank{os.environ['RANK']}.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2:])
