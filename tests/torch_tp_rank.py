"""One rank of a tensor-parallel process group of ``tests/test_torch_tp.py``,
``test_torch_tp_moe.py``, ``test_torch_tp_ssm.py`` or
``test_torch_tp_attn.py`` (CPU, gloo).

    python tests/torch_tp_rank.py DIR JOB [JOB ...]

The test starts one such process per rank with torchrun's environment.
Each rank reads ``DIR/inputs.npz`` (the reference's global f32 parameters
of ``inputs["arch"]``'s reduced config under ``params/``, a batch, a
prompt and the reference's Zen hash seeds; or, with ``inputs["archs"]``,
the same under ``<arch>/`` for each of several configs), joins the mesh
``DxM`` with M = 2 and D = the process count / 2 through
``launch.mesh.make_mesh_groups("gloo", 2, device="cpu")``, runs the JOBs and
writes ``DIR/rank<r>.npz`` (a config's results under ``<arch>/``, a JOB
``ARCH:JOB`` running on that config alone).  It imports only torch, numpy
and ``repro_torch``: the JAX reference runs in the test's processes.

Jobs:
  weights  a build from seed 0, gathered (``checkpoint.io.gather_params``),
           and whether a seed-1 build given those global leaves
           (``checkpoint.io.load_params``) holds the seed-0 shards;
  grads    the step-0 loss and every leaf's gradient over the whole batch,
           gathered to its global shape (both MoE dispatches for an MoE
           config);
  sgd      2 SGD steps without a clip: the losses;
  loss0    the step-0 loss of a dense-sync AdamW step;
  trainer  4 AdamW steps with Zen (the reference's hash seeds) under
           ZeRO-1 and under the full update: losses, grad norms, this
           model rank's ``sync/*`` words and overflow each step, the
           gathered parameters and the moments' bytes;
  ckpt     2 steps, and 1 step saved (rank 0 writes the gathered
           checkpoint), restored into a fresh trainer and stepped once:
           the losses and parameters of both;
  moe      2 AdamW steps, dense sync, of each MoE dispatch: losses and
           ``moe/*`` stats;
  precision  the hybrid's gradient (every leaf, gathered) at 7 layers, one
           group of 6 and a tail layer, from seed 0, in f32 and with float64
           weights and activations;
  serve    prefill of the prompt (and its frames or patches: this rank's
           cache share of every layer, the gathered last-position logits),
           then 7 greedy decode steps from the handed-off cache: 8 tokens;
           again with the decode cache whole on every rank
           (``decode_seq_shard`` off).
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


def torch_inputs(inp: dict, pre: str) -> dict:
    """``inp``'s arrays under ``pre`` (``batch/``, ``serve/``) as tensors:
    token ids int64, whisper's frames and pixtral's patches f32."""
    out = {}
    for key, val in inp.items():
        if key.startswith(pre) and key[len(pre):] in (
                "tokens", "labels", *st.MODEL_INPUTS):
            t = torch.from_numpy(val)
            out[key[len(pre):]] = t if t.is_floating_point() else t.long()
    return out


class Rank:
    def __init__(self, inp: dict, groups):
        self.inp = inp
        self.cfg = cfg_of(inp)
        self.group, self.mgroup, _ = groups
        self.world = DistGroup()
        self.mesh = f"{self.group.n}x{TP}"
        self.batch = torch_inputs(inp, "batch/")

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
    model = r.program(reference=False).model
    full = io.gather_params(model)
    for name, a in full.items():
        out[f"seed0/{name}"] = a.detach().numpy()
    other = r.program(seed=1, reference=False).model
    io.load_params(other, full)
    out["seed0/load_params_bitwise"] = np.array(all(
        torch.equal(p, q) for (_, p), (_, q) in zip(model.named_leaves(),
                                                    other.named_leaves())))


def job_grads(r: Rank, out: dict) -> None:
    for a2a in ((False, True) if r.cfg.kind == "moe" else (False,)):
        model = r.program(moe_a2a=a2a).model
        loss = model(**r.batch)
        loss.backward()
        out[f"grads/{int(a2a)}/loss"] = np.array(loss.item())
        for name, g in r.gathered(model, grads=True).items():
            out[f"grads/{int(a2a)}/{name}"] = g


def job_sgd(r: Rank, out: dict) -> None:
    prog = r.trainer(TrainerConfig(opt=OptConfig(kind="sgd", lr=0.1,
                                                 grad_clip=0.0)))
    out["sgd/losses"] = np.array([float(prog.train_step(r.batch)["loss"])
                                  for _ in range(2)])


def job_loss0(r: Rank, out: dict) -> None:
    prog = r.trainer(TrainerConfig(sync=SyncConfig(scheme="dense")))
    out["loss0"] = np.array(float(prog.train_step(r.batch)["loss"]))


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
    path = work / f"ck_{r.cfg.name}"
    if r.world.ranks[0] == 0:
        io.save(path, tree)
    dist.barrier()
    back = io.restore(path, device="cpu")
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


def job_precision(r: Rank, out: dict) -> None:
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        cfg = dataclasses.replace(r.cfg, n_layers=7, shared_attn_every=6,
                                  dtype=dtype)
        model = build_program(cfg, r.mesh, device="cpu", group=r.group,
                              model_group=r.mgroup).model
        model(**r.batch).backward()
        for name, g in r.gathered(model, grads=True).items():
            out[f"precision/{tag}/{name}"] = g


def job_serve(r: Rank, out: dict) -> None:
    for whole in (False, True):
        prog = r.program()
        if whole:   # the decode cache whole on every rank
            ctx = dataclasses.replace(prog.model.ctx, decode_seq_shard=False)
            prog.model = Model(r.cfg, device="cpu", ctx=ctx)
            prog.model.load_reference_params(reference_tree(r.inp))
        pre = "serve" + ("_whole" if whole else "")
        prompt = torch_inputs(r.inp, "serve/")
        B, S = prompt["tokens"].shape
        attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
        logits, cache = prog.prefill_step(prompt)
        for i, c in enumerate(cache["layers"]):
            for k, v in c.items():
                for kk, vv in (v.items() if isinstance(v, dict)
                               else ((None, v),)):
                    out["/".join(filter(None, (f"{pre}/cache/{i}/{k}",
                                               kk)))] = vv.numpy()
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
        attn = [c for c in cache["layers"] if "pos" in c]
        if attn:
            out[f"{pre}/pos"] = attn[0]["pos"].numpy()


def main(work: Path, jobs: list[str]) -> None:
    torch.set_num_threads(1)
    inp = dict(np.load(work / "inputs.npz"))
    out: dict = {}
    groups = make_mesh_groups("gloo", TP, device="cpu")
    archs = [str(a) for a in inp["archs"]] if "archs" in inp else [""]
    try:
        for arch in archs:
            pre = f"{arch}/" if arch else ""
            r = Rank({k[len(pre):]: v for k, v in inp.items()
                      if k.startswith(pre)}, groups)
            res: dict = {}
            for job in jobs:
                want, _, job = job.rpartition(":")
                if want and want != arch:
                    continue
                if job == "ckpt":
                    job_ckpt(r, res, work)
                else:
                    globals()[f"job_{job}"](r, res)
            out.update({pre + k: v for k, v in res.items()})
    finally:
        dist.destroy_process_group()
    np.savez(work / f"rank{os.environ['RANK']}.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2:])
