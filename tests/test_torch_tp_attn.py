"""Tensor parallelism of the port (``--mesh DxM``, M = 2) for MLA
(minicpm3-4b), the encoder-decoder (whisper-medium, ``kind="enc_dec"``)
and the VLM (pixtral-12b, ``kind="vlm"``), reduced, f32, against the
reference and the port's own 1x1 run (``tests/torch_tp_kinds.py``; a 2x2
and a 1x2 group of rank processes and a reference process a config, all
started once for the module).

MLA's ``q_up`` / ``kv_up`` are column-parallel and o row-parallel, its
latent cache sequence-sharded; whisper's encoder and cross-attention
heads and its GELU MLPs are sharded, the cross cache replicated;
pixtral's patch projection is replicated.  The reference's (1, 2) decode
mixes the heads' partial softmaxes over the sequence-sharded cache
(ROADMAP queue 3), which a case records for each; the port's 1x2 tokens
are its 1x1 ones.  minicpm3 also runs the 2x2 Zen trainer and its
checkpoint.
"""
import dataclasses

import jax
import numpy as np
import pytest

import torch_tp_kinds as K
from repro.models.common import make_ctx as ref_make_ctx
from repro.models.model import build_model
from repro_torch.models.common import make_ctx
from repro_torch.models.model import Model
from test_torch_tp import port_cfg, ref_cfg, stub_group

ARCHS = ["minicpm3-4b", "whisper-medium", "pixtral-12b"]
ZEN = ("minicpm3-4b",)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = K.start(ARCHS, ZEN, tmp_path_factory)
    yield out
    K.stop(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_are_the_reference_shards(groups, arch):
    K.check_weights(groups, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_matches_reference_at_the_same_mesh(groups, arch):
    K.check_step0_loss(groups, arch, arch in ZEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_1x2_equal_the_1x1_gradient(groups, arch):
    K.check_gradients(groups, arch)


def test_minicpm3_trainer_2x2_matches_reference(groups):
    K.check_trainer(groups, "minicpm3-4b")


def test_minicpm3_checkpoint_2x2_continues_bitwise(groups):
    K.check_checkpoint(groups, "minicpm3-4b")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_1x2_matches_reference_and_1x1(groups, arch):
    K.check_serve(groups, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tp_decode_mixes_heads(groups, arch):
    """Records a reference-side fault (ROADMAP queue 3): at (1, 2) the
    reference's ``mla_decode`` / ``gqa_decode`` sums the partial
    softmaxes of different heads over the sequence-sharded cache, so its
    decoded tokens part from its own (1, 1) ones in every sequence;
    the port's 1x2 tokens are its 1x1 ones (the serve case above)."""
    t12, t11 = K.reference_tokens(groups, arch)
    assert (t12[:, 0] == t11[:, 0]).all()      # the prefill's argmax
    assert (t12[:, 1:] != t11[:, 1:]).any(axis=1).all()


def test_mla_padded_heads_are_the_reference_shards():
    """``pad_heads`` at tp = 4 on a 6-head variant of the reduced minicpm3
    (heads padded to 8, 2 a rank): each model rank's ``q_up`` / ``kv_up``
    columns and ``o`` rows after ``load_reference_params`` are slices of
    the reference's padded global leaves (``init_mla`` zeroes the padded
    heads'), and the port's own build zeroes the same ones."""
    arch = "minicpm3-4b"
    rcfg = dataclasses.replace(ref_cfg(arch), n_heads=6)
    cfg = dataclasses.replace(port_cfg(arch), n_heads=6)
    rctx = ref_make_ctx(rcfg, 4, 1, pad_heads=True)
    assert (rctx.h_pad, rctx.shard_heads) == (8, True)
    tree = jax.tree.map(np.asarray, build_model(rcfg, rctx).init(
        jax.random.PRNGKey(0))[0])
    widths = {"q_up": cfg.hd + cfg.mla_rope_dim,
              "kv_up": cfg.hd + cfg.mla_v_dim, "o": cfg.mla_v_dim}
    for m in range(4):
        ctx = make_ctx(cfg, 4, 1, pad_heads=True, group=stub_group(m, 4))
        model = Model(cfg, device="cpu", ctx=ctx)
        own = {n: getattr(model.layers[0].attn, n).w.detach().clone()
               for n in widths}
        model.load_reference_params(tree)
        for name, w in widths.items():
            got = getattr(model.layers[0].attn, name).w.detach().numpy()
            ref = tree["layers"]["attn"][f"{name}_w"][0]
            dim = 0 if name == "o" else 1
            np.testing.assert_array_equal(
                got, np.take(ref, range(m * 2 * w, (m + 1) * 2 * w), dim))
            # heads 6 and 7 (rank 3's) are padding, zero in both builds
            assert (m == 3) == (not got.any()) == (not own[name].any()), \
                (m, name)
