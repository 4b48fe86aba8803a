"""Tensor parallelism of the port (``--mesh DxM``, M = 2) for the Mamba2
LM (mamba2-370m, ``kind="ssm"``) and the hybrid (zamba2-1.2b: Mamba2
layers and the shared attention block), reduced, f32, against the
reference and the port's own 1x1 run (``tests/torch_tp_kinds.py``; a 2x2
and a 1x2 group of rank processes and a reference process a config, all
started once for the module).

The SSM heads and d_inner are sharded over the model axis (``in_z``,
``in_x``, ``in_dt`` column-parallel, ``in_bc`` replicated, ``out``
row-parallel, the conv, per-head vectors and gated norm sliced), so each
rank's ``ssd_fwd`` scans its own heads.  mamba2 has no sequence-sharded
cache, so its 1x2 tokens also equal the reference's (1, 2) tokens;
zamba2's shared block decodes over the sequence-sharded cache, where the
reference's (1, 2) decode mixes heads (ROADMAP queue 3), which a case
records.  mamba2 also runs the 2x2 Zen trainer and its checkpoint.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_tp_kinds as K
from repro_torch.models.model import Model
from test_torch_tp import port_cfg
from torch_tp_rank import torch_inputs

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
ZEN = ("mamba2-370m",)
# zamba2's 1x2 gradient gate, a share of a leaf's largest value: the
# port's 1x1 gradient and the reference's (two f32 orders of the same
# sums) part by up to 5.5e-5 of it on this batch, which the case checks
# (its 1x2 gradient parts from the 1x1 one by up to 1.0e-4); the hybrid's
# own parity gate against the reference (tests/test_torch_hybrid.py)
HYBRID_GRAD_TOL = 2e-4
# zamba2's prefill-logit gate at 1x2: the hybrid's parity gate against the
# reference (tests/test_torch_hybrid.py); the port's 1x1 logits part from
# the reference's (1, 1) ones by more than 1e-5 (1.76e-5 on this prompt),
# which the case checks, and its 1x2 logits from the reference's (1, 2)
# ones by 1.37e-5
HYBRID_LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small ops: a pool of threads
    in each test worker only contends with the other workers' pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = K.start(ARCHS, ZEN, tmp_path_factory,
                  ("zamba2-1.2b:precision",))
    yield out
    K.stop(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_are_the_reference_shards(groups, arch):
    K.check_weights(groups, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_matches_reference_at_the_same_mesh(groups, arch):
    K.check_step0_loss(groups, arch, arch in ZEN)


def test_mamba2_gradients_1x2_equal_the_1x1_gradient(groups):
    K.check_gradients(groups, "mamba2-370m")


def test_zamba2_gradients_1x2_equal_the_1x1_gradient(groups):
    K.check_gradients(groups, "zamba2-1.2b", HYBRID_GRAD_TOL, control=True)


def test_zamba2_tp_gradient_gap_is_rounding(groups):
    """zamba2 at 7 layers (one group of 6 Mamba2 layers after the shared
    block, and a tail layer), seed 0: its 1x2 gradient parts from the 1x1
    one by more than 4x less once the weights and activations are float64
    (the norms, the scan and the loss stay f32), so the f32 gap is
    rounding carried through the Mamba2 layers, not a misplaced
    collective, which no precision would close (3.4e-4 and 9.9e-6 of a
    leaf's largest value on this batch)."""
    arch = "zamba2-1.2b"
    cfg = dataclasses.replace(port_cfg(arch), n_layers=7, shared_attn_every=6)
    batch = torch_inputs(groups["inp"][arch], "batch/")
    res = K.ranks(groups, 2, arch)[0]
    gaps = {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        model = Model(dataclasses.replace(cfg, dtype=dtype), device="cpu")
        model(**batch).backward()
        gaps[tag] = max(
            float(np.abs(res[f"precision/{tag}/{n}"] - p.grad.numpy()).max()
                  / np.abs(p.grad.numpy()).max())
            for n, p in model.named_leaves())
    assert gaps["f64"] * 4 < gaps["f32"], gaps


def test_mamba2_trainer_2x2_matches_reference(groups):
    K.check_trainer(groups, "mamba2-370m")


def test_mamba2_checkpoint_2x2_continues_bitwise(groups):
    K.check_checkpoint(groups, "mamba2-370m")


def test_mamba2_serve_1x2_matches_reference_and_1x1(groups):
    K.check_serve(groups, "mamba2-370m")


def test_zamba2_serve_1x2_matches_reference_and_1x1(groups):
    K.check_serve(groups, "zamba2-1.2b", HYBRID_LOGIT_TOL, control=True)


def test_mamba2_tokens_equal_the_reference_1x2(groups):
    """No decode cache is sequence-sharded: the reference's (1, 2) tokens
    are its (1, 1) ones and the port's."""
    t12, t11 = K.reference_tokens(groups, "mamba2-370m")
    np.testing.assert_array_equal(t12, t11)
    np.testing.assert_array_equal(
        K.port_serve_1x1(groups, "mamba2-370m")[0], t12)


def test_reference_hybrid_tp_decode_mixes_heads(groups):
    """Records a reference-side fault (ROADMAP queue 3): zamba2's shared
    block decodes with the reference's ``gqa_decode``, which at (1, 2)
    sums the partial softmaxes of different heads, so its decoded tokens
    part from its own (1, 1) ones in every sequence; the port's 1x2
    tokens are its 1x1 ones (the serve case above)."""
    t12, t11 = K.reference_tokens(groups, "zamba2-1.2b")
    assert (t12[:, 0] == t11[:, 0]).all()      # the prefill's argmax
    assert (t12[:, 1:] != t11[:, 1:]).any(axis=1).all()
