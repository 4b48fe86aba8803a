"""ZeRO-1 sharded optimizer state (``train/steps.py``), against the
reference's (``repro.train.steps``: ``opt_chunk_size``, ``init_opt_state``,
the chunked update) and against the port's full update.

* the moments' shapes are the reference's ``init_opt_state`` at world 4
  (mesh 4x1) and at 2 pods of 2 (2x2x1: world P x D = 4, pod-major), leaf
  by leaf (a 1-layer model, so that the reference's stacked leaves are the
  port's per-layer ones): ``[world, c]`` f32, c = ceil(n / world); with
  ``zero1=False`` the leaf's own shape;
* after 3 steps of the reduced qwen2 trainer in the config's bf16, the
  parameters, the moments (the full update's, flattened, zero-padded to
  world x c) and the EF residual (never chunked) under ZeRO-1 are bitwise
  those of the full update, with AdamW, SGD, ``--compress topk:0.01`` and
  on 2 pods of 2;
* the reduced f32 trainer under ZeRO-1 at 4x1, from the reference's
  parameters, within 1e-3 of the reference's own ZeRO-1 step run over 4
  simulated devices (``jax.vmap`` over ``data``, each device given its
  ``[1, c]`` rows of the moments), 3 steps, as
  ``tests/test_torch_ef_trainer.py`` holds the compressed trainer;
* a ZeRO-1 state round-trips through ``checkpoint/io.py`` and the
  restored trainer continues bit for bit.

The 2-rank gloo case (each process holding its own ``[1, c]`` row, bitwise
the in-process run) is ``tests/test_torch_dist.py``'s ``zero1`` job.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.core.zen import SyncConfig as RefSyncConfig
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro.optim.optimizers import OptConfig as RefOptConfig
from repro.train import steps as rst
from repro_torch.checkpoint import io
from repro_torch.configs import get_config
from repro_torch.core.zen import SyncConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig, opt_chunk_size

N, SEQ, BATCH, STEPS = 4, 16, 4, 3
MESHES = {"4x1": (1, 4), "2x2x1": (2, 2)}       # mesh -> (pods, data)
CASES = {"adamw": ("4x1", OptConfig(), SyncConfig()),
         "sgd": ("4x1", OptConfig(kind="sgd"), SyncConfig()),
         "compress": ("4x1", OptConfig(),
                      SyncConfig(compress="topk:0.01", bucket_bytes=1 << 18)),
         "pods": ("2x2x1", OptConfig(), SyncConfig())}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_path(tree, name: str):
    """The reference's leaf under the port's name, for a model of one
    layer (its stacked leaves [1, ...]): ``layers/0/attn/q/w`` is
    ``tree["layers"]["attn"]["q_w"]``, ``layers/0/ln1/scale``
    ``tree["layers"]["ln1"]``, ``embed/table`` ``tree["embed"]["table"]``,
    ``lm_head/w`` ``tree["lm_head_w"]``."""
    parts = name.split("/")
    if parts[0] == "layers":
        tree, parts = tree["layers"], parts[2:]
    if parts == ["embed", "table"]:
        return tree["embed"]["table"]
    if parts[-1] == "scale":
        return tree[parts[0]]
    if len(parts) == 3:
        return tree[parts[0]][f"{parts[1]}_{parts[2]}"]
    return tree[f"{parts[0]}_{parts[1]}"]


def _batches(cfg, n: int) -> list[dict]:
    it = iter(SyntheticLM(cfg, DataConfig(seq_len=SEQ, batch=BATCH)))
    return [{k: torch.as_tensor(v).long() for k, v in next(it).items()}
            for _ in range(n)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_shapes_equal_reference(mesh):
    pods, dp = MESHES[mesh]
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                                  n_layers=1)
    ctx = make_ctx(ref_cfg, 1, dp, pods)
    shapes, specs = build_model(ref_cfg, ctx).abstract()
    want = rst.abstract_opt_state(rst.TrainerConfig(), shapes, ctx,
                                  specs)["leaves"]
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=1)
    for zero1 in (True, False):
        prog = build_program(cfg, mesh, TrainerConfig(zero1=zero1),
                             device="cpu")
        attach_train(prog)
        leaves = prog.opt_state()["leaves"]
        assert len(leaves) == len(jax.tree.leaves(shapes))
        for name, p in prog.model.named_leaves():
            st = leaves[name]
            ref = ref_path(want, name)
            assert set(st) == set(ref) == {"m", "v"}, name
            for k, m in st.items():
                assert m.dtype == torch.float32
                if zero1:
                    c = opt_chunk_size(p.numel(), pods * dp)
                    assert tuple(m.shape) == tuple(ref[k].shape) == \
                        (pods * dp, c), name
                else:
                    assert tuple(m.shape) == tuple(p.shape), name


def _run(case: str, zero1: bool):
    mesh, opt, sync = CASES[case]
    cfg = get_config("qwen2-0.5b").reduced()
    prog = build_program(cfg, mesh, TrainerConfig(opt=opt, sync=sync,
                                                  zero1=zero1), device="cpu")
    attach_train(prog)
    metrics = [prog.train_step(b) for b in _batches(cfg, STEPS)]
    return prog, metrics


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("case", list(CASES))
def test_zero1_is_bitwise_the_full_update(case):
    z, zm = _run(case, True)
    f, fm = _run(case, False)
    for a, b in zip(zm, fm):
        for k in ("loss", "grad_norm"):
            assert torch.equal(a[k], b[k]), k
    assert z.model.embed.table.dtype == torch.bfloat16
    for (name, p), (_, q) in zip(z.model.named_leaves(),
                                 f.model.named_leaves()):
        assert torch.equal(_bits(p.detach()), _bits(q.detach())), name
    zs, fs = z.opt_state(), f.opt_state()
    assert zs["step"] == fs["step"] == STEPS
    world = z.group.n
    for name, p in z.model.named_leaves():
        for k, full in fs["leaves"][name].items():
            chunked = zs["leaves"][name][k]
            c = opt_chunk_size(p.numel(), world)
            assert tuple(chunked.shape) == (world, c)
            flat = chunked.reshape(-1)
            assert torch.equal(_bits(flat[:p.numel()]),
                               _bits(full.reshape(-1))), (name, k)
            assert not flat[p.numel():].any(), (name, k)
    assert ("residual" in zs) == ("residual" in fs) == (case == "compress")
    for k, r in fs.get("residual", {}).items():
        assert r.shape == zs["residual"][k].shape    # per rank, unchunked
        assert torch.equal(_bits(r), _bits(zs["residual"][k])), k


def _ref_cfg():
    return dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                               dtype=jnp.float32)


def _ref_zero1_losses(ref_params, batch):
    """The reference's per-device ZeRO-1 train step over N simulated
    devices: ``jax.vmap`` over ``data``, the parameters replicated, each
    device holding its [1, c] rows of the [N, c] moments."""
    cfg = _ref_cfg()
    ctx = make_ctx(cfg, 1, N)
    model = build_model(cfg, ctx)
    shapes, specs = model.abstract()
    tcfg = rst.TrainerConfig(opt=RefOptConfig(),
                             sync=RefSyncConfig(scheme="dense"), zero1=True)
    step_fn = rst.make_train_step(model, tcfg, specs)
    opt = rst.init_opt_state(tcfg, ref_params, ctx, specs)
    params = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape),
                          ref_params)
    state = {"leaves": jax.tree.map(lambda m: m.reshape(N, 1, -1),
                                    opt["leaves"]),
             "step": jnp.zeros((N,), jnp.int32)}
    jb = {k: jnp.asarray(v).reshape(N, -1, v.shape[-1])
          for k, v in batch.items()}
    fn = jax.jit(jax.vmap(step_fn, axis_name="data"))
    losses = []
    for _ in range(STEPS):
        params, state, m = fn(params, state, jb)
        losses.append(float(m["loss"][0]))
    return losses, jax.tree.leaves(opt["leaves"])[0].shape


def test_zero1_trainer_matches_reference_zero1():
    ref_params = build_model(_ref_cfg(), make_ctx(_ref_cfg(), 1, 1)).init(
        jax.random.PRNGKey(0))[0]
    batch = next(iter(RefSyntheticLM(_ref_cfg(),
                                     RefDataConfig(seq_len=SEQ, batch=BATCH))))
    ref, ref_shape = _ref_zero1_losses(ref_params, batch)
    assert ref_shape[0] == N
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    prog = build_program(cfg, f"{N}x1", TrainerConfig(
        sync=SyncConfig(scheme="dense")), device="cpu")
    prog.model.load_reference_params(jax.tree.map(np.asarray, ref_params))
    attach_train(prog)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    losses = [float(prog.train_step(tb)["loss"]) for _ in range(STEPS)]
    assert all(np.isfinite(losses)), losses
    assert np.max(np.abs(np.array(losses) - np.array(ref))) < 1e-3, \
        (losses, ref)
    m = prog.opt_state()["leaves"]["embed/table"]["m"]
    assert m.shape[0] == N


def _load_state(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _load_state(dst[k], v)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def test_zero1_checkpoint_round_trip(tmp_path):
    cfg = get_config("qwen2-0.5b").reduced()
    batches = _batches(cfg, 2)

    def trainer():
        prog = build_program(cfg, "2x2x1", device="cpu")
        attach_train(prog)
        return prog

    full = trainer()
    want = [full.train_step(b) for b in batches]
    part = trainer()
    part.train_step(batches[0])
    io.save(tmp_path / "ck", {"params": dict(part.model.named_leaves()),
                              "opt": part.opt_state()})
    back = io.restore(tmp_path / "ck", device="cpu")
    emb = back["opt"]["leaves"]["embed/table"]["v"]
    assert back["opt"]["step"] == 1 and tuple(emb.shape) == (
        4, opt_chunk_size(part.model.embed.table.numel(), 4))
    fresh = trainer()
    with torch.no_grad():
        for name, p in fresh.model.named_leaves():
            p.copy_(back["params"][name])
    _load_state(fresh.opt_state(), back["opt"])
    got = fresh.train_step(batches[1])
    assert torch.equal(got["loss"], want[1]["loss"])
    for (_, p), (_, q) in zip(fresh.model.named_leaves(),
                              full.model.named_leaves()):
        assert torch.equal(_bits(p.detach()), _bits(q.detach()))
