"""Port parity: the Mamba2 trainer on ``mamba2-370m.reduced()`` in f32.

The reference's parameters (its threefry init) are carried over with
``Model.load_reference_params``:

* the step-0 loss is within 1e-4 of the reference ``model.train_loss`` and
  every leaf's gradient within rtol 1e-4 (atol 1e-4 of the leaf's largest
  reference gradient), the bounds the qwen2 trainer is held to;
* a 4-step loss trajectory of the port at mesh 4x1 with zen sync is within
  1e-3 of the reference's in-process (1,1) run, with no overflow;
* ``ops.SSDScan`` (the scan under autograd: ``ssd_fwd_op`` forward, the
  plain scan's gradient backward) gives the gradients of autograd through
  ``ref.ssd_fwd_ref`` bit for bit, on CPU tensors;
* the plain scan's gradient stays finite past exp's range, where the
  reference's is NaN.
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
from repro.train.build import attach_train as ref_attach_train
from repro.train.build import build_program as ref_build_program
from repro.train.steps import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core.zen import SyncConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import ssd_fwd_ref
from repro_torch.models.model import Model
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

ARCH = "mamba2-370m"
SEQ, BATCH, STEPS = 32, 4, 4
MIXER_W = ("in_z", "in_x", "in_dt", "in_bc", "out")
MIXER_P = ("conv_w", "conv_b", "A_log", "dt_bias", "D", "norm")


def _ref_cfg():
    return dataclasses.replace(ref_get_config(ARCH).reduced(),
                               dtype=jnp.float32)


def _port_cfg():
    return dataclasses.replace(get_config(ARCH).reduced(),
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def ref_params():
    return build_model(_ref_cfg(), make_ctx(_ref_cfg(), 1, 1)).init(
        jax.random.PRNGKey(0))[0]


@pytest.fixture(scope="module")
def batch():
    return next(iter(RefSyntheticLM(_ref_cfg(),
                                    RefDataConfig(seq_len=SEQ, batch=BATCH))))


def _port_model(ref_params) -> Model:
    port = Model(_port_cfg(), device="cpu")
    port.load_reference_params(jax.tree.map(np.asarray, ref_params))
    return port


def test_step0_loss_and_grads_match_reference(ref_params, batch):
    cfg = _ref_cfg()
    model = build_model(cfg, make_ctx(cfg, 1, 1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_g = jax.value_and_grad(
        model.train_loss, has_aux=True)(ref_params, jb)

    port = _port_model(ref_params)
    tops.reset_counts()
    loss = port(torch.as_tensor(batch["tokens"]).long(),
                torch.as_tensor(batch["labels"]).long())
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) < 1e-4, (loss.item(),
                                                       float(ref_loss))
    # two scans a layer: the plain forward (CPU tensors) and the layer's
    # recompute in the backward; one plain recompute in SSDScan's backward
    assert tops.PLAIN_CALLS["ssd_fwd"] == 2 * cfg.n_layers
    assert tops.RECOMPUTE_CALLS["ssd_fwd"] == cfg.n_layers
    grads = {n: p.grad for n, p in port.named_leaves()}
    ly = ref_g["layers"]
    pairs = [("embed/table", ref_g["embed"]["table"]),
             ("lm_head/w", ref_g["lm_head_w"]), ("ln_f/scale", ref_g["ln_f"])]
    for i in range(cfg.n_layers):
        pre = f"layers/{i}/"
        pairs.append((pre + "ln1/scale", ly["ln1"][i]))
        pairs += [(pre + f"mixer/{k}/w", ly["mixer"][f"{k}_w"][i])
                  for k in MIXER_W]
        pairs += [(pre + f"mixer/{k}", ly["mixer"][k][i]) for k in MIXER_P]
    assert len(pairs) == len(grads)
    for name, rg in pairs:
        rg = np.asarray(rg)
        np.testing.assert_allclose(grads[name].numpy(), rg, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(rg).max()) + 1e-9,
                                   err_msg=name)
    rows = np.flatnonzero(np.abs(grads["embed/table"].numpy()).sum(1))
    assert set(rows) <= set(np.unique(batch["tokens"]))


def _ref_losses(ref_params, batch):
    mesh = make_mesh((1, 1), ("data", "model"))
    prog = ref_build_program(_ref_cfg(), mesh, RefTrainerConfig(
        sync=RefSyncConfig(scheme="dense")))
    ref_attach_train(prog, seq_len=SEQ, global_batch=BATCH)
    params = jax.tree.map(jnp.asarray, ref_params)
    opt = prog.init_opt(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        params, opt, m = prog.train_step(params, opt, jb)
        losses.append(float(m["loss"]))
    return losses


def test_trainer_4x1_zen_matches_reference_1x1(ref_params, batch):
    prog = build_program(_port_cfg(), "4x1",
                         TrainerConfig(sync=SyncConfig(scheme="zen")),
                         device="cpu")
    prog.model.load_reference_params(jax.tree.map(np.asarray, ref_params))
    attach_train(prog)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    tops.reset_counts()
    losses, overflow, words = [], [], []
    for _ in range(STEPS):
        m = prog.train_step(tb)
        losses.append(float(m["loss"]))
        overflow.append(float(m["sync/overflow"]))
        words.append(float(m["sync/sparse_sent_words"]))
    ref = _ref_losses(ref_params, batch)
    assert all(np.isfinite(losses)), losses
    assert np.max(np.abs(np.array(losses) - np.array(ref))) < 1e-3, \
        (losses, ref)
    assert overflow == [0.0] * STEPS
    assert min(words) > 0
    # each rank's step: Zen's fused route once, and two scans a layer (the
    # layer's forward and its recompute in the backward)
    n_layers = _port_cfg().n_layers
    assert tops.PLAIN_CALLS == {
        k: 4 * STEPS * ((k in tops.path_kernels())
                        + 2 * n_layers * (k == "ssd_fwd"))
        for k in tops.KERNELS}
    assert tops.RECOMPUTE_CALLS["ssd_fwd"] == 4 * STEPS * n_layers
    assert not any(tops.LAUNCHES.values())


@pytest.mark.parametrize("shape", [(2, 32, 4, 8, 16, 16), (1, 48, 2, 32, 8, 16)],
                         ids=["Q16", "Q16-3chunks"])
def test_ssd_scan_backward_is_the_plain_scans_gradient(shape):
    """Bitwise, for both outputs used and for y alone (the trainer's
    case: the final state is not used)."""
    Bt, S, H, hd, N, Q = shape
    rng = np.random.default_rng(7)

    def r(*s, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32))

    x, Bm, Cm = r(Bt, S, H, hd, scale=0.5), r(Bt, S, N, scale=0.4), \
        r(Bt, S, N, scale=0.4)
    dA = -torch.from_numpy(rng.random((Bt, S, H)).astype(np.float32))
    gy, gst = r(Bt, S, H, hd), r(Bt, H, hd, N)
    for use_state in (True, False):
        ins = [t.clone().requires_grad_() for t in (x, dA, Bm, Cm)]
        tops.reset_counts()
        y, st = tops.SSDScan.apply(*ins, Q)
        outs, ups = ([y, st], [gy, gst]) if use_state else ([y], [gy])
        got = torch.autograd.grad(outs, ins, ups)
        assert tops.PLAIN_CALLS["ssd_fwd"] == 1
        assert tops.RECOMPUTE_CALLS["ssd_fwd"] == 1
        ref_ins = [t.clone().requires_grad_() for t in (x, dA, Bm, Cm)]
        ry, rst = ssd_fwd_ref(*ref_ins, chunk=Q)
        assert torch.equal(y, ry) and torch.equal(st, rst)
        routs = [ry, rst] if use_state else [ry]
        want = torch.autograd.grad(routs, ref_ins, ups)
        for name, a, b in zip(("x", "dA", "Bm", "Cm"), got, want):
            assert torch.equal(a, b), (name, use_state)


@pytest.mark.parametrize("rate", [1.0, 1.5], ids=["in-range", "past-exp"])
def test_plain_scan_gradient_finite_past_exps_range(rate):
    """A chunk whose decay span passes exp's f32 range (rate x 63 steps >
    88): the port's plain scan keeps every gradient finite, where the
    reference's jnp scan, which masks after the exp, gives NaN for dt;
    in range both give the same gradients (to f32 rounding)."""
    from repro.models.ssm import _ssd_chunked as ref_ssd_chunked
    from repro_torch.models.ssm import _ssd_chunked

    Bt, S, H, hd, N = 1, 64, 2, 8, 4
    rng = np.random.default_rng(5)
    xh, Bm = (rng.standard_normal(s).astype(np.float32)
              for s in ((Bt, S, H, hd), (Bt, S, N)))
    Cm = 0.5 * Bm
    dt = np.full((Bt, S, H), rate, np.float32)
    zeros = np.zeros((H,), np.float32)

    def ref_loss(xh, dt):
        return ref_ssd_chunked(xh, dt, zeros, Bm, Cm, zeros, 64)[0].sum()

    rgx, rgdt = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(xh),
                                                    jnp.asarray(dt))
    assert bool(jnp.isfinite(rgdt).all()) == (rate == 1.0)
    ins = [torch.from_numpy(a).requires_grad_() for a in (xh, dt)]
    y, _ = _ssd_chunked(ins[0], ins[1], torch.from_numpy(zeros),
                        torch.from_numpy(Bm), torch.from_numpy(Cm),
                        torch.from_numpy(zeros), 64, backend="torch")
    gx, gdt = torch.autograd.grad(y.sum(), ins)
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), rtol=1e-4,
                               atol=1e-4)
    if rate == 1.0:
        np.testing.assert_allclose(gdt.numpy(), np.asarray(rgdt), rtol=1e-4,
                                   atol=1e-3)
