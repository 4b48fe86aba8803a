"""The JAX reference's tensor-parallel runs for ``tests/test_torch_tp.py``
and ``tests/test_torch_tp_moe.py``, in a process of its own with 4 forced
host devices (its XLA flags must be set before JAX is imported).

    python tests/torch_tp_reference.py OUT.npz dense|moe
    python tests/torch_tp_reference.py OUT.npz arch ARCH [zen]
    python tests/torch_tp_reference.py OUT.npz mesh3 ARCH [ARCH ...]

All in f32 on the reduced configs, from the 1-device init of seed 0
(the parameters the tests give the port), with the tests' batch
(``SyntheticLM``, 4 x 32 tokens) and prompt (2 x 16 tokens).  ``dense``
(qwen2-0.5b): one AdamW step (clip 1.0) at (1, 1) and (1, 2): the loss and ``grad_norm``;
every parameter of the (2, 2) mesh's own init, gathered and as each
device's shard; 4
AdamW steps with Zen at (2, 2): the losses and each device's
``sync/sparse_sent_words`` and ``sync/overflow`` (its own, before
``shard_map`` returns device 0's); the prefill at (1, 2): the gathered
last-position logits and each model rank's cache shard; at (1, 2) and
(1, 1) 8 greedy tokens by replaying the prompt through decode.  ``moe`` (olmoe-1b-7b,
``capacity_factor=4.0``): 2 AdamW steps with dense sync at (2, 2) for each
dispatch, the losses and ``moe/*``.  ``arch ARCH`` (the
SSM, hybrid, MLA, enc_dec and vlm configs of ``tests/test_torch_tp_ssm.py``
and ``tests/test_torch_tp_attn.py``): every parameter of the (2, 2)
mesh's own init, gathered and as each device's shard; one AdamW step
(dense sync) at (1, 2): the loss and ``grad_norm``; at (2, 2) the step-0
loss of one such step, or with ``zen`` 4 AdamW steps with Zen: the losses
and each device's ``sync/sparse_sent_words`` and ``sync/overflow``; the
prefill at (1, 2) and (1, 1): the gathered last-position logits, and
at (1, 2) each model rank's cache shard; at both 8 greedy tokens: the prefill's
argmax, then 7 decode steps from the prefill's cache carried into the
decode cache (each model rank's slots, as the port's
``launch/serve.py::handoff`` carries them).  Keys are '/'-joined; a
device is named by its mesh coordinates ``d<d>m<m>``.

``mesh3`` (``tests/test_torch_mesh3.py``; 8 forced host devices) runs
each ARCH (``olmoe-1b-7b`` with ``moe_a2a``) at the meshes ``(pod, data,
model)`` = (2, 2, 2) and ``(data, model)`` = (4, 2) split into nodes of
2 (``(dp_inter, dp_intra, model)``), from the 1-device init placed on
each: every parameter's shard on each device, and 4 AdamW steps with Zen
on the mesh3 batch (8 x 32 tokens): the losses and each device's
``sync/sparse_sent_words``, ``sync/intra_words``, ``sync/inter_words``
and ``sync/overflow``; for qwen2-0.5b also the prefill at (2, 2) of the
mesh3 prompt (4 x 16 tokens): the gathered last-position logits.  Keys
are ``<arch>/<layout>/...``, a device named ``r<rank>`` by its place in
the mesh, model innermost (the port's world rank).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + (
    "8" if sys.argv[2:3] == ["mesh3"] else "4")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.zen import SyncConfig  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.common import make_ctx  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.train.build import (attach_serve, attach_train,  # noqa: E402
                               build_program)
from repro.train.steps import TrainerConfig  # noqa: E402

SEQ, BATCH, STEPS = 32, 4, 4
PROMPT, PROMPT_BATCH, GEN = 16, 2, 8


def cfg_of(arch: str):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=jnp.float32)
    if cfg.kind == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    return cfg


def batch_of(cfg, seq: int, batch: int) -> dict:
    b = next(iter(SyntheticLM(cfg, DataConfig(seq_len=seq, batch=batch))))
    return {k: jnp.asarray(v) for k, v in b.items()}


def coords(mesh, device) -> str:
    d, m = (int(i) for i in np.argwhere(mesh.devices == device)[0])
    return f"d{d}m{m}"


def shards(mesh, arr) -> dict:
    """{device coords: that device's shard} of a global array."""
    return {coords(mesh, s.device): np.asarray(s.data)
            for s in arr.addressable_shards}


def placed(cfg, prog):
    """The 1-device init from seed 0 (the parameters the tests give the
    port), placed on ``prog``'s mesh: the mesh's own init differs from it
    by an ulp in places."""
    params = build_model(cfg, make_ctx(cfg, 1, 1)).init(
        jax.random.PRNGKey(0))[0]
    specs = jax.tree.map(lambda s: jax.sharding.NamedSharding(prog.mesh, s),
                         prog.param_specs, is_leaf=lambda x: isinstance(
                             x, jax.sharding.PartitionSpec))
    return jax.device_put(params, specs)


def train(cfg, shape, scheme: str, steps: int, **kw):
    mesh = make_mesh(shape, ("data", "model"))
    prog = build_program(cfg, mesh, TrainerConfig(
        sync=SyncConfig(scheme=scheme)), **kw)
    attach_train(prog, seq_len=SEQ, global_batch=BATCH)
    params = placed(cfg, prog)
    opt = prog.init_opt(params)
    batch = batch_of(cfg, SEQ, BATCH)
    metrics = []
    for _ in range(steps):
        params, opt, m = prog.train_step(params, opt, batch)
        metrics.append(m)
    return mesh, prog, metrics


def dense(out: dict) -> None:
    cfg = cfg_of("qwen2-0.5b")
    for shape in ((1, 1), (1, 2)):
        _, _, (m,) = train(cfg, shape, "dense", 1)
        tag = f"{shape[0]}x{shape[1]}"
        out[f"loss0/{tag}"] = float(m["loss"])
        out[f"grad_norm/{tag}"] = float(m["grad_norm"])
    mesh, prog, ms = train(cfg, (2, 2), "zen", STEPS)
    out["t22/loss"] = np.array([float(m["loss"]) for m in ms])
    for k in ("sync/sparse_sent_words", "sync/overflow"):
        for m in ms:
            for dev, v in shards(mesh, m[k]).items():
                out.setdefault(f"t22/{k}/{dev}", []).append(float(v))
    params = prog.init_params(0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(k.key) for k in path)
        out[f"p22/{name}"] = np.asarray(jax.device_get(leaf))
        for dev, v in shards(mesh, leaf).items():
            out[f"shard/{name}/{dev}"] = v
    # serve at (1, 2), and decode at (1, 1)
    prompt = batch_of(cfg, PROMPT, PROMPT_BATCH)["tokens"]
    for shape in ((1, 2), (1, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        prog = build_program(cfg, mesh)
        params = placed(cfg, prog)
        tag = f"{shape[0]}x{shape[1]}"
        if shape == (1, 2):
            attach_serve(prog, seq_len=PROMPT, global_batch=PROMPT_BATCH,
                         mode="prefill")
            logits, cache = prog.prefill_step(params, {"tokens": prompt})
            out["serve/logits"] = np.asarray(logits)
            for k, v in cache["layers"].items():
                for dev, s in shards(mesh, v).items():
                    out[f"serve/cache/{k}/{dev}"] = s
        attach_serve(prog, seq_len=PROMPT + GEN, global_batch=PROMPT_BATCH,
                     mode="decode")
        cache = prog.fresh_cache()
        for t in range(PROMPT):
            nxt, _, cache = prog.decode_step(params, cache,
                                             prompt[:, t:t + 1])
        toks = [nxt]
        for _ in range(GEN - 1):
            nxt, _, cache = prog.decode_step(params, cache, nxt)
            toks.append(nxt)
        out[f"serve/tokens/{tag}"] = np.concatenate(
            [np.asarray(t) for t in toks], 1)


def moe(out: dict) -> None:
    cfg = cfg_of("olmoe-1b-7b")
    for a2a in (False, True):
        _, _, ms = train(cfg, (2, 2), "dense", 2, moe_a2a=a2a)
        for k in ("loss", "moe/aux_loss", "moe/dropped", "moe/skew"):
            out[f"moe/{int(a2a)}/{k}"] = np.array([float(m[k]) for m in ms])


def handoff(pf: dict, cache: dict, tp: int, t: int) -> dict:
    """The decode ``cache`` (global, fresh) continuing the prefill cache
    ``pf`` (global, numpy): each attention entry's prompt slots go to the
    first slots of the same model rank's block along the sequence axis
    (axis 2 of k, v, c and kr, axis 1 of pos: [layers, B, tp * Sl, ...]);
    Mamba2 entries and the cross cache as they are; ``t``."""
    out = dict(cache)
    for group, val in pf.items():
        if group == "t":
            continue
        if not (isinstance(val, dict) and "pos" in val):
            out[group] = jax.tree.map(jnp.asarray, val)
            continue
        new = {}
        for k, v in val.items():
            ax = 1 if k == "pos" else 2
            dst = np.moveaxis(np.array(cache[group][k]), ax, 0)
            src = np.moveaxis(v, ax, 0)
            sl, sl2 = src.shape[0] // tp, dst.shape[0] // tp
            dst = dst.reshape(tp, sl2, *dst.shape[1:])
            dst[:, :sl] = src.reshape(tp, sl, *src.shape[1:])
            new[k] = jnp.asarray(np.moveaxis(
                dst.reshape(tp * sl2, *dst.shape[2:]), 0, ax))
        out[group] = new
    out["t"] = jnp.asarray(t, jnp.int32)
    return out


def arch_runs(out: dict, arch: str, zen: bool) -> None:
    cfg = cfg_of(arch)
    mesh = make_mesh((2, 2), ("data", "model"))
    prog = build_program(cfg, mesh)
    params = prog.init_params(0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(k.key) for k in path)
        out[f"p22/{name}"] = np.asarray(jax.device_get(leaf))
        for dev, v in shards(mesh, leaf).items():
            out[f"shard/{name}/{dev}"] = v
    _, _, (m,) = train(cfg, (1, 2), "dense", 1)
    out["loss0/1x2"] = float(m["loss"])
    out["grad_norm/1x2"] = float(m["grad_norm"])
    mesh, _, ms = train(cfg, (2, 2), "zen" if zen else "dense",
                        STEPS if zen else 1)
    out["t22/loss"] = np.array([float(m["loss"]) for m in ms])
    if zen:
        for k in ("sync/sparse_sent_words", "sync/overflow"):
            for m in ms:
                for dev, v in shards(mesh, m[k]).items():
                    out.setdefault(f"t22/{k}/{dev}", []).append(float(v))
    b = batch_of(cfg, PROMPT, PROMPT_BATCH)
    prompt = {k: v for k, v in b.items() if k != "labels"}
    t = PROMPT + (cfg.n_patches if cfg.kind == "vlm" else 0)
    for shape in ((1, 2), (1, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        prog = build_program(cfg, mesh)
        params = placed(cfg, prog)
        tag = f"{shape[0]}x{shape[1]}"
        attach_serve(prog, seq_len=PROMPT, global_batch=PROMPT_BATCH,
                     mode="prefill")
        logits, pf = prog.prefill_step(params, prompt)
        out[f"serve/logits/{tag}"] = np.asarray(logits)
        if shape == (1, 2):
            for path, v in jax.tree_util.tree_flatten_with_path(pf)[0]:
                name = "/".join(str(k.key) for k in path)
                if name != "t":
                    for dev, s in shards(mesh, v).items():
                        out[f"serve/cache/{name}/{dev}"] = s
        pf = jax.tree.map(np.asarray, pf)
        attach_serve(prog, seq_len=PROMPT + GEN, global_batch=PROMPT_BATCH,
                     mode="decode")
        cache = handoff(pf, prog.fresh_cache(), shape[1], t)
        nxt = jnp.argmax(logits.astype(jnp.float32), -1)[:, None]
        toks = [nxt]
        for _ in range(GEN - 1):
            nxt, _, cache = prog.decode_step(params, cache, nxt)
            toks.append(nxt)
        out[f"serve/tokens/{tag}"] = np.concatenate(
            [np.asarray(t) for t in toks], 1)


MESH3_BATCH, MESH3_PROMPT_BATCH = 8, 4
MESH3_LAYOUTS = {"2x2x2": ((2, 2, 2), ("pod", "data", "model"), 1),
                 "4x2n2": ((4, 2), ("data", "model"), 2)}


def rank_of(mesh, device) -> str:
    idx = np.argwhere(mesh.devices == device)[0]
    return f"r{int(np.ravel_multi_index(tuple(idx), mesh.devices.shape))}"


def mesh3(out: dict, archs: list[str]) -> None:
    for arch in archs:
        cfg = cfg_of(arch)
        a2a = cfg.kind == "moe"
        batch = batch_of(cfg, SEQ, MESH3_BATCH)
        for tag, (shape, axes, ns) in MESH3_LAYOUTS.items():
            pre = f"{arch}/{tag}"
            mesh = make_mesh(shape, axes, node_size=ns)
            prog = build_program(cfg, mesh, TrainerConfig(
                sync=SyncConfig(scheme="zen")), moe_a2a=a2a)
            attach_train(prog, seq_len=SEQ, global_batch=MESH3_BATCH)
            params = placed(cfg, prog)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]:
                name = "/".join(str(k.key) for k in path)
                for s in leaf.addressable_shards:
                    out[f"{pre}/shard/{name}/{rank_of(mesh, s.device)}"] = \
                        np.asarray(s.data)
            opt = prog.init_opt(params)
            losses = []
            for _ in range(STEPS):
                params, opt, m = prog.train_step(params, opt, batch)
                losses.append(float(m["loss"]))
                for k in ("sync/sparse_sent_words", "sync/intra_words",
                          "sync/inter_words", "sync/overflow"):
                    if k in m:
                        for s in m[k].addressable_shards:
                            out.setdefault(
                                f"{pre}/{k}/{rank_of(mesh, s.device)}",
                                []).append(float(np.asarray(s.data)))
            out[f"{pre}/loss"] = np.array(losses)
        if arch == "qwen2-0.5b":
            mesh = make_mesh((2, 2), ("data", "model"))
            prog = build_program(cfg, mesh)
            attach_serve(prog, seq_len=PROMPT,
                         global_batch=MESH3_PROMPT_BATCH, mode="prefill")
            prompt = batch_of(cfg, PROMPT, MESH3_PROMPT_BATCH)["tokens"]
            logits, _ = prog.prefill_step(placed(cfg, prog),
                                          {"tokens": prompt})
            out[f"{arch}/serve22/logits"] = np.asarray(logits)


if __name__ == "__main__":
    res: dict = {}
    if sys.argv[2] == "mesh3":
        mesh3(res, sys.argv[3:])
    elif sys.argv[2] == "arch":
        arch_runs(res, sys.argv[3], sys.argv[4:] == ["zen"])
    else:
        {"dense": dense, "moe": moe}[sys.argv[2]](res)
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in res.items()})
