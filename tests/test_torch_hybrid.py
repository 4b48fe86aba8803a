"""Port parity: the hybrid ``zamba2-1.2b`` (``kind="hybrid"``).

* the port's config equals the reference's field by field, ``source`` and
  ``reduced()`` included;
* at a small depth that has a tail (5 layers, the shared attention block
  every 2: two groups of 2 Mamba2 layers and one tail layer; d_model 256,
  vocab 512, SSM state 16 in chunks of 16), in f32 with the reference's
  parameters carried over (``Model.load_reference_params``): prefill's
  last-position logits within 1e-4 and its cache within rtol 1e-4 (atol
  1e-4 of the entry's largest value), then two greedy decode steps
  from the cache ``launch/serve.py::handoff`` makes (the shared block's
  K/V copied into its two attention entries, the Mamba2 entries taken as
  they are): the same tokens, max logits within 1e-4; the step-0 loss
  within 1e-4 and every leaf's gradient within rtol 1e-4 and atol 2e-4
  of the leaf's largest gradient, the shared block's (one leaf a
  parameter, summed over its two applications) included.  The atol is
  twice the 2-layer trainers': through seven layer applications, five of
  them Mamba2, f32 rounding alone moves the port's gradients by up to
  1.6e-4 of a leaf's largest from the same port run in float64 (which
  agrees with the reference within 3e-5 of it); a 2-layer Mamba2 model
  stays under 1e-5;
* ``launch.serve`` and ``launch.train`` run the arch with ``--reduced
  --device cpu``: every prefill layer on the kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch.mesh import make_mesh
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro.train.build import attach_serve as ref_attach_serve
from repro.train.build import build_program as ref_build_program
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.train.build import attach_serve, build_program

ARCH = "zamba2-1.2b"
B, S, GEN = 2, 12, 2
TOL = dict(atol=1e-4, rtol=1e-4)
FIELDS = ("name", "kind", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "vocab_padded", "hd", "head_dim", "qkv_bias",
          "rope_theta", "n_experts", "top_k", "capacity_factor",
          "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk",
          "d_inner", "ssm_heads", "shared_attn_every", "sliding_window",
          "source")
MIXER_W = ("in_z", "in_x", "in_dt", "in_bc", "out")
MIXER_P = ("conv_w", "conv_b", "A_log", "dt_bias", "D", "norm")


def _small(cfg):
    """Five layers, the shared block every 2 (a tail of one), reduced
    widths, f32."""
    return dataclasses.replace(cfg.reduced(), n_layers=5,
                               shared_attn_every=2)


def _ref_cfg():
    return dataclasses.replace(_small(ref_get_config(ARCH)),
                               dtype=jnp.float32)


def _port_cfg():
    return dataclasses.replace(_small(get_config(ARCH)), dtype=torch.float32)


def test_config_matches_reference():
    assert ARCH in ALL_ARCHS
    for ref, port in ((ref_get_config(ARCH), get_config(ARCH)),
                      (ref_get_config(ARCH).reduced(),
                       get_config(ARCH).reduced()),
                      (_ref_cfg(), _port_cfg())):
        for f in FIELDS:
            assert getattr(ref, f) == getattr(port, f), f
    z = get_config(ARCH)
    assert (z.n_layers, z.d_model, z.n_heads, z.n_kv, z.hd, z.ssm_state,
            z.ssm_heads, z.shared_attn_every) == (38, 2048, 32, 32, 64, 64,
                                                  64, 6)
    assert z.hd in ops.FLASH_HEAD_DIMS and z.ssm_head_dim in ops.SSD_HEAD_DIMS
    assert z.ssm_state in ops.SSD_STATE_DIMS
    assert z.ssm_chunk <= ops.SSD_MAX_CHUNK


def _ssm_leaves(pre: str, tree, at) -> dict:
    out = {pre + "ln1/scale": at(tree["ln1"])}
    mx = tree["mixer"]
    out.update({pre + f"mixer/{k}/w": at(mx[f"{k}_w"]) for k in MIXER_W})
    out.update({pre + f"mixer/{k}": at(mx[k]) for k in MIXER_P})
    return out


def _port_names(tree, cfg) -> dict:
    """The reference's hybrid parameter (or gradient) tree under the
    port's leaf names."""
    every = cfg.shared_attn_every
    ng, nt = cfg.n_layers // every, cfg.n_layers % every
    out = {"embed/table": tree["embed"]["table"],
           "lm_head/w": tree["lm_head_w"], "ln_f/scale": tree["ln_f"]}
    for g in range(ng):
        for j in range(every):
            out.update(_ssm_leaves(f"groups/{g}/{j}/", tree["groups"]["inner"],
                                   lambda a, g=g, j=j: np.asarray(a)[g, j]))
    for i in range(nt):
        out.update(_ssm_leaves(f"tail/{i}/", tree["tail"],
                               lambda a, i=i: np.asarray(a)[i]))
    sh = tree["shared"]
    out.update({"shared/ln1/scale": sh["ln1"], "shared/ln2/scale": sh["ln2"]})
    out.update({f"shared/attn/{k}/w": sh["attn"][f"{k}_w"] for k in "qkvo"})
    out.update({f"shared/ffn/{k}/w": sh["ffn"][f"{k}_w"]
                for k in ("gate", "up", "down")})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref_run():
    """The reference's parameters, prefill, two decode steps from its
    cache, and the step-0 loss and gradients, on one SyntheticLM batch."""
    cfg = _ref_cfg()
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = prog.init_params(0)
    data = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=S, batch=B))))
    logits, pf = prog.prefill_step(params,
                                   {"tokens": jnp.asarray(data["tokens"])})
    pf = jax.tree.map(np.asarray, pf)
    ref_attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = prog.fresh_cache()
    cache["attn"] = {k: v.at[:, :, :S].set(pf["attn"][k])
                     if k != "pos" else v.at[:, :S].set(pf["attn"][k])
                     for k, v in cache["attn"].items()}
    cache["ssm"] = jax.tree.map(jnp.asarray, pf["ssm"])
    cache["ssm_tail"] = jax.tree.map(jnp.asarray, pf["ssm_tail"])
    cache["t"] = jnp.asarray(S, jnp.int32)
    tok = jnp.argmax(logits.astype(jnp.float32), axis=-1)[:, None]
    toks, lmax = [np.asarray(tok)[:, 0]], []
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(params, cache, tok)
        toks.append(np.asarray(tok)[:, 0])
        lmax.append(np.asarray(m))
    params = jax.tree.map(np.asarray, params)
    model = build_model(cfg, make_ctx(cfg, 1, 1))
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    (loss, _), grads = jax.value_and_grad(model.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jb)
    return {"params": params, "data": data,
            "logits": np.asarray(logits, np.float32), "cache": pf,
            "gen": np.stack(toks, 1), "lmax": np.stack(lmax),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


def _program(run):
    prog = build_program(_port_cfg(), "1x1", device="cpu")
    prog.model.load_reference_params(run["params"])
    return prog


def test_prefill_and_decode_match_reference(ref_run):
    prog = _program(ref_run)
    model, cfg = prog.model, prog.model.cfg
    # execution order: [shared, g0.0, g0.1, shared, g1.0, g1.1, tail.0]
    kinds = ["attn" if ly is model.shared else "ssm"
             for ly in model.exec_layers]
    assert kinds == ["attn", "ssm", "ssm"] * 2 + ["ssm"]
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    ops.reset_counts()
    logits, cache = prog.prefill_step(
        {"tokens": torch.as_tensor(ref_run["data"]["tokens"]).long()})
    assert ops.PLAIN_CALLS["flash_fwd"] == 2
    assert ops.PLAIN_CALLS["ssd_fwd"] == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
    rc = ref_run["cache"]
    want = []
    for g in range(2):
        want.append({k: rc["attn"][k][g] for k in ("k", "v", "pos")})
        want += [{k: rc["ssm"][k][g, j] for k in ("state", "conv")}
                 for j in range(2)]
    want.append({k: rc["ssm_tail"][k][0] for k in ("state", "conv")})
    assert cache["t"] == S and len(cache["layers"]) == len(want)
    for i, (got, ref) in enumerate(zip(cache["layers"], want)):
        assert set(got) == set(ref), i
        for k in got:   # the gradients' bound: the SSD states reach ~20
            np.testing.assert_allclose(
                got[k].numpy(), ref[k], rtol=1e-4,
                atol=1e-4 * float(np.abs(ref[k]).max()) + 1e-9,
                err_msg=f"cache entry {i} {k}")
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = serve.handoff(prog, cache)
    assert cache["layers"][0]["k"].shape[1] == S + GEN
    tok = logits.float().argmax(-1)[:, None]
    toks, lmax = [tok[:, 0].numpy()], []
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(cache, tok)
        toks.append(tok[:, 0].numpy())
        lmax.append(m.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)
    # both decode steps wrote the shared block's K/V into both of its
    # attention entries
    for i in (0, 3):
        assert cache["layers"][i]["pos"].tolist() == list(range(S + GEN))


def test_step0_loss_and_grads_match_reference(ref_run):
    model = _program(ref_run).model
    data = ref_run["data"]
    loss, metrics = model.train_loss(torch.as_tensor(data["tokens"]).long(),
                                     torch.as_tensor(data["labels"]).long())
    assert set(metrics) == {"loss"} and metrics["loss"] is loss
    ops.reset_counts()
    loss.backward()
    assert abs(loss.item() - ref_run["loss"]) < 1e-4, (loss.item(),
                                                       ref_run["loss"])
    grads = {n: p.grad for n, p in model.named_leaves()}
    want = _port_names(ref_run["grads"], model.cfg)
    # one leaf per parameter: the shared block's are not repeated per group
    assert set(grads) == set(want)
    assert sum(n.startswith("shared/") for n in grads) == 9
    for name, rg in want.items():
        np.testing.assert_allclose(grads[name].numpy(), rg, rtol=1e-4,
                                   atol=2e-4 * float(np.abs(rg).max()) + 1e-9,
                                   err_msg=name)


def test_entry_points_run_on_cpu():
    ops.reset_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    cfg = get_config(ARCH).reduced()
    assert cfg.shared_attn_every == 1 and cfg.n_layers == 2
    assert res["tokens"].shape == (2, 3)
    assert np.isfinite(res["logit_max"]).all()
    # one shared-block application a group, one scan a Mamba2 layer
    assert res["plain_calls"] == {"flash_fwd": 2, "ssd_fwd": 2}
    assert not any(res["launches"].values())
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1", "--mesh", "2x1", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all() and out["overflow"] == 0
    assert out["sparse_words"] > 0 and "moe" not in out
    assert out["plain_calls"]["ssd_fwd"] == 2 * 2 * cfg.n_layers
