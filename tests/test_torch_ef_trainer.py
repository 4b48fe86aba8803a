"""Port parity: the reduced qwen2-0.5b trainer with EF compression and with
SGD, in f32, against the reference's (its parameters carried over with
``Model.load_reference_params``).

* ``--compress topk:0.01`` at mesh 4x1, 4 steps: within 1e-3 of the
  reference's own per-device train step run over 4 simulated devices
  (``jax.vmap`` over ``data``: its GradSync, EF residual in the optimizer
  state, clip and AdamW), no overflow.  Both sides fuse every dense leaf
  into one bucket (all leaves are f32), so the top-k of each rank picks the
  same elements although the port's leaves are per layer and the
  reference's are stacked; the residual rides in ``step_fn.state``;
* ``OptConfig(kind="sgd")`` at 4x1 with zen: within 1e-3 of the
  reference's 1x1 run (the DESIGN.md §9 cross-mesh gate, as
  tests/test_torch_trainer.py holds AdamW).
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
from repro.launch.mesh import make_mesh
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro.optim.optimizers import OptConfig as RefOptConfig
from repro.train import steps as rst
from repro.train.build import attach_train as ref_attach_train
from repro.train.build import build_program as ref_build_program
from repro.train.steps import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core.zen import SyncConfig
from repro_torch.kernels import ops as tops
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

SEQ, BATCH, STEPS, N = 32, 4, 4, 4
ONE_BUCKET = 1 << 26   # every dense leaf of the reduced f32 model


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here: the suite runs in parallel
    workers, where torch's default pool oversubscribes the cores and these
    tests' many small ops on ~1M-element tensors slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg():
    return dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                               dtype=jnp.float32)


def _port_cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def ref_params():
    return build_model(_ref_cfg(), make_ctx(_ref_cfg(), 1, 1)).init(
        jax.random.PRNGKey(0))[0]


@pytest.fixture(scope="module")
def batch():
    return next(iter(RefSyntheticLM(_ref_cfg(),
                                    RefDataConfig(seq_len=SEQ, batch=BATCH))))


def _port_losses(ref_params, batch, tcfg):
    prog = build_program(_port_cfg(), f"{N}x1", tcfg, device="cpu")
    prog.model.load_reference_params(jax.tree.map(np.asarray, ref_params))
    attach_train(prog)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    tops.reset_counts()
    losses, overflow = [], []
    for _ in range(STEPS):
        m = prog.train_step(tb)
        losses.append(float(m["loss"]))
        overflow.append(float(m["sync/overflow"]))
    return prog, losses, overflow


def _ref_compressed_losses(ref_params, batch, spec):
    """The reference's per-device train step (``make_train_step``, no
    ZeRO-1) over N simulated devices: ``jax.vmap`` over ``data``, the
    parameters and moments replicated, the EF residual one per device."""
    cfg = _ref_cfg()
    ctx = make_ctx(cfg, 1, N)
    model = build_model(cfg, ctx)
    shapes, specs = model.abstract()
    tcfg = RefTrainerConfig(sync=RefSyncConfig(
        scheme="zen", compress=spec, bucket_bytes=ONE_BUCKET), zero1=False)
    gs = rst.make_gradsync(model, tcfg, specs, shapes)
    step_fn = rst.make_train_step(model, tcfg, specs, gradsync=gs)
    opt = rst.init_opt_state(tcfg, ref_params, ctx, specs, gradsync=gs)

    def tile(x):
        return jnp.broadcast_to(x, (N,) + jnp.shape(x))

    params = jax.tree.map(tile, ref_params)
    state = {"leaves": jax.tree.map(tile, opt["leaves"]),
             "step": tile(opt["step"]),
             "residual": {k: v.reshape(N, -1)
                          for k, v in opt["residual"].items()}}
    jb = {k: jnp.asarray(v).reshape(N, -1, v.shape[-1])
          for k, v in batch.items()}
    fn = jax.jit(jax.vmap(step_fn, axis_name="data"))
    losses, overflow = [], []
    for _ in range(STEPS):
        params, state, m = fn(params, state, jb)
        losses.append(float(m["loss"][0]))
        overflow.append(float(m["sync/overflow"][0]))
    return gs, losses, overflow


def test_compressed_trainer_4x1_matches_reference(ref_params, batch):
    spec = "topk:0.01"
    ref_gs, ref, ref_ovf = _ref_compressed_losses(ref_params, batch, spec)
    prog, losses, overflow = _port_losses(ref_params, batch, TrainerConfig(
        sync=SyncConfig(scheme="zen", compress=spec,
                        bucket_bytes=ONE_BUCKET)))
    gs = prog.gradsync
    # one compressed dense bucket of the same size on both sides
    assert list(gs.compressed_buckets().values()) == \
        list(ref_gs.compressed_buckets().values())
    assert all(np.isfinite(losses)), losses
    assert np.max(np.abs(np.array(losses) - np.array(ref))) < 1e-3, \
        (losses, ref)
    assert overflow == ref_ovf == [0.0] * STEPS
    assert losses[-1] < losses[0]
    # the residual rides in the optimizer state, [ranks, S] per bucket
    state = prog.opt_state()
    assert state["step"] == STEPS
    assert {k: tuple(v.shape) for k, v in state["residual"].items()} == \
        {k: (N, s) for k, s in gs.compressed_buckets().items()}
    assert all(bool(v.abs().sum() > 0) for v in state["residual"].values())
    # every rank encodes, serves and decodes each zen bucket once a step,
    # and runs each layer's attention twice (its forward and its recompute)
    n_zen, L = len(gs._layouts), _port_cfg().n_layers
    assert tops.PLAIN_CALLS == {
        k: N * STEPS * (n_zen * (k in tops.path_kernels())
                        + 2 * L * (k == "flash_fwd"))
        for k in tops.KERNELS}


def _ref_sgd_losses(ref_params, batch):
    mesh = make_mesh((1, 1), ("data", "model"))
    prog = ref_build_program(_ref_cfg(), mesh, RefTrainerConfig(
        opt=RefOptConfig(kind="sgd"), sync=RefSyncConfig(scheme="dense")))
    ref_attach_train(prog, seq_len=SEQ, global_batch=BATCH)
    params = jax.tree.map(jnp.asarray, ref_params)
    opt = prog.init_opt(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        params, opt, m = prog.train_step(params, opt, jb)
        losses.append(float(m["loss"]))
    return losses


def test_sgd_trainer_4x1_matches_reference(ref_params, batch):
    prog, losses, overflow = _port_losses(ref_params, batch, TrainerConfig(
        opt=OptConfig(kind="sgd"), sync=SyncConfig(scheme="zen")))
    ref = _ref_sgd_losses(ref_params, batch)
    assert all(np.isfinite(losses)), losses
    assert np.max(np.abs(np.array(losses) - np.array(ref))) < 1e-3, \
        (losses, ref)
    assert overflow == [0.0] * STEPS
    state = prog.opt_state()
    assert "residual" not in state and state["step"] == STEPS
    leaf = next(iter(state["leaves"].values()))
    assert set(leaf) == {"mom"} and leaf["mom"].dtype == torch.float32


def test_unknown_optimizer_and_opt_state_before_attach():
    prog = build_program(_port_cfg(), "2x1", TrainerConfig(
        sync=SyncConfig(compress="topk:0.01")), device="cpu")
    with pytest.raises(ValueError, match="residual"):
        prog.opt_state()
    prog = build_program(_port_cfg(), "2x1", TrainerConfig(
        opt=OptConfig(kind="lion")), device="cpu")
    with pytest.raises(ValueError, match="lion"):
        attach_train(prog)
