"""Tensor parallelism of the port for the MoE decoder (olmoe-1b-7b
reduced, 4 experts top-2, ``capacity_factor=4.0`` so that no pair drops,
f32): both dispatches, ``moe_ffn_replicated`` and the token-sharded
``moe_ffn_a2a``, against the reference and the port's own 1x1 run.

A 2x2 and a 1x2 group of ``tests/torch_tp_rank.py`` processes and the
reference's runs (``tests/torch_tp_reference.py``) start together:

* at 2x2, 2 AdamW steps of each dispatch: the losses within 1e-5 of the
  reference's at (2, 2) with the same dispatch, the ``moe/*`` stats equal
  to the reference's (rtol 1e-6), and the a2a run within 1e-4 of the
  replicated one at step 0 (the reference's own gate, its
  ``tests/test_multidevice.py`` ``run_moe``);
* at 1x2, the step-0 loss and every leaf's gradient, gathered, of each
  dispatch within 1e-5 max|g| of the port's 1x1 gradient: the all-to-alls'
  and the all-gather's backward give the true gradient.
"""
import numpy as np
import pytest

import jax

from repro_torch.models.model import Model
from test_torch_tp import port_cfg, start, torch_batch

ARCH = "olmoe-1b-7b"


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = start(ARCH, ["moe"], ["grads"], "moe", tmp_path_factory)
    yield out
    for procs in (out[4], out[2], out["ref"]):
        procs.kill()


@pytest.mark.parametrize("a2a", [0, 1], ids=["replicated", "a2a"])
def test_moe_2x2_matches_reference(groups, a2a):
    ref = groups["ref"].results()
    for res in groups[4].results():
        np.testing.assert_allclose(res[f"moe/{a2a}/loss"],
                                   ref[f"moe/{a2a}/loss"], rtol=0, atol=1e-5)
        for k in ("moe/aux_loss", "moe/dropped", "moe/skew"):
            np.testing.assert_allclose(res[f"moe/{a2a}/{k}"],
                                       ref[f"moe/{a2a}/{k}"], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        assert abs(res["moe/1/loss"][0] - res["moe/0/loss"][0]) < 1e-4
    assert abs(ref["moe/1/loss"][0] - ref["moe/0/loss"][0]) < 1e-4


@pytest.mark.parametrize("a2a", [0, 1], ids=["replicated", "a2a"])
def test_moe_gradients_1x2_equal_the_1x1_gradient(groups, a2a):
    model = Model(port_cfg(ARCH), device="cpu")
    model.load_reference_params(jax.tree.map(np.asarray, groups["params"]))
    b = torch_batch(groups["inp"])
    loss = model(b["tokens"], b["labels"])
    loss.backward()
    for res in groups[2].results():
        assert abs(float(res[f"grads/{a2a}/loss"]) - loss.item()) < 1e-5
        for name, p in model.named_leaves():
            want = p.grad.numpy()
            np.testing.assert_allclose(
                res[f"grads/{a2a}/{name}"], want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()) + 1e-12, err_msg=name)
