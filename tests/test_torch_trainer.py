"""Port parity: the qwen2-0.5b trainer on ``qwen2-0.5b.reduced()`` in f32.

The reference's parameters (its threefry init) are carried over with
``Model.load_reference_params``:

* the step-0 loss is within 1e-4 of the reference ``model.train_loss``;
* the gradients match with rtol 1e-4;
* a 4-step loss trajectory of the port at mesh 4x1 with zen sync is within
  1e-3 of the reference's in-process (1,1) run, with no overflow -- the
  DESIGN.md §9 cross-mesh gate of tests/test_multidevice.py.
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
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops as tops
from repro_torch.models.model import Model
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig

SEQ, BATCH, STEPS = 32, 4, 4


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


def test_config_and_data_match_reference(batch):
    ref, port = _ref_cfg(), _port_cfg()
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
              "hd", "qkv_bias", "rope_theta", "vocab_padded"):
        assert getattr(ref, f) == getattr(port, f), f
    full = get_config("qwen2-0.5b")
    assert full.vocab_padded == 151936 and full.d_model == 896
    got = next(iter(SyntheticLM(port, DataConfig(seq_len=SEQ, batch=BATCH))))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], batch[k])


def test_step0_loss_and_grads_match_reference(ref_params, batch):
    cfg = _ref_cfg()
    model = build_model(cfg, make_ctx(cfg, 1, 1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, _), ref_g = jax.value_and_grad(
        model.train_loss, has_aux=True)(ref_params, jb)

    port = Model(_port_cfg(), device="cpu")
    port.load_reference_params(jax.tree.map(np.asarray, ref_params))
    loss = port(torch.as_tensor(batch["tokens"]).long(),
                torch.as_tensor(batch["labels"]).long())
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) < 1e-4, (loss.item(),
                                                       float(ref_loss))
    # the port's grads, put back into the reference's stacked pytree
    grads = {n: p.grad for n, p in port.named_leaves()}
    ly = ref_g["layers"]
    pairs = [("embed/table", ref_g["embed"]["table"]),
             ("lm_head/w", ref_g["lm_head_w"]), ("ln_f/scale", ref_g["ln_f"])]
    for i in range(cfg.n_layers):
        pre = f"layers/{i}/"
        pairs += [(pre + "ln1/scale", ly["ln1"][i]),
                  (pre + "ln2/scale", ly["ln2"][i])]
        pairs += [(pre + f"attn/{k}/{s}", ly["attn"][f"{k}_{s}"][i])
                  for k in "qkvo" for s in "wb" if f"{k}_{s}" in ly["attn"]]
        pairs += [(pre + f"ffn/{k}/w", ly["ffn"][f"{k}_w"][i])
                  for k in ("gate", "up", "down")]
    assert len(pairs) == len(grads)
    for name, rg in pairs:
        rg = np.asarray(rg)
        np.testing.assert_allclose(grads[name].numpy(), rg, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(rg).max()) + 1e-9,
                                   err_msg=name)
    # the embedding gradient is row-sparse: only the batch's tokens
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
    # every rank encodes, serves and decodes once per step (plain route on
    # the CPU), through the fused route's kernels only; each layer's
    # attention runs twice a rank a step (its forward, and its recompute
    # in the backward), with one plain backward
    L = _port_cfg().n_layers
    assert tops.PLAIN_CALLS == {
        k: 4 * STEPS * ((k in tops.path_kernels()) + 2 * L * (k == "flash_fwd"))
        for k in tops.KERNELS}
    assert tops.RECOMPUTE_CALLS["flash_fwd"] == 4 * STEPS * L
    assert losses[-1] < losses[0]
