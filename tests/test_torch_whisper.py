"""Port parity: the encoder-decoder ``whisper-medium`` (``kind="enc_dec"``).

* the port's config equals the reference's field by field (``n_enc_layers``,
  ``enc_len``, ``source`` and the rest), ``reduced()`` included (2 + 2
  layers, 24 frames);
* ``SyntheticLM``'s batches, stub ``frames`` included, bitwise the
  reference's (drawn after the tokens from the same generator);
* the reduced model in f32 with the reference's parameters carried over
  (``Model.load_reference_params``), at ``tests/test_torch_zoo.py``'s
  tolerance (atol and rtol 1e-4): the encoder output, the prefill's
  last-position logits and its cross cache (each layer's K/V of the
  encoder output), two greedy decode steps from the cache
  ``launch/serve.py::handoff`` makes (the same tokens, max logits), the
  step-0 loss, and every leaf's gradient (rtol 1e-4, atol 1e-4 of the
  leaf's largest; the key biases', zero but for rounding since a softmax
  does not see a shift of a query's scores, atol 1e-4 of their key
  weights' largest); a prefill takes 2 + 2 + 2 attentions (encoder, self,
  cross) on the plain ``flash_fwd`` and a decode step 2 (cross);
* the same model in bf16 (the config's dtype): the frames are f32, so the
  encoder runs in f32 activations on bf16 weights on both sides (JAX's
  promotion; ``models/attention.py``'s docstring): its output within
  1e-4 of the reference's (2.4e-6 measured); the loss within 1e-2 (1.9e-3)
  and the prefill's logits within 0.1 (0.023: about 6 and 1.5 bf16 ulps
  at their largest |logit|, 3.2), where the port rounds the cross K/V to
  bf16 once for the kernel (the reference attends to them in f32) and the
  two frameworks round their bf16 matmuls apart;
* a 2x1 train step on ``SimGroup``: the loss the mean of the reference's
  losses on the two ranks' rows (frames split with the tokens) within
  1e-4, the grad norm that of the mean of their gradients within rtol
  1e-4, overflow 0;
* ``launch.serve`` and ``launch.train`` run the arch with ``--reduced
  --device cpu``.
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
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.train.build import attach_serve, attach_train, build_program

ARCH = "whisper-medium"
B, S, GEN = 2, 12, 2
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_LOSS_TOL, BF16_LOGIT_TOL = 1e-2, 0.1
FIELDS = ("name", "kind", "n_layers", "n_enc_layers", "enc_len",
          "n_patches", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
          "vocab_padded", "hd", "head_dim", "qkv_bias", "rope_theta",
          "mla_q_rank", "mla_kv_rank", "mla_rope_dim", "mla_v_dim",
          "sliding_window", "source")


def _ref_cfg(dtype=jnp.float32):
    return dataclasses.replace(ref_get_config(ARCH).reduced(), dtype=dtype)


def _port_cfg(dtype=torch.float32):
    return dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)


def ref_leaf(tree, name: str) -> np.ndarray:
    """The reference's leaf (parameter or gradient) under the port's name:
    ``enc_layers/3/attn/q/w`` is ``tree["enc_layers"]["attn"]["q_w"][3]``,
    ``layers/0/lnx/scale`` ``tree["layers"]["lnx"][0]``, ``lm_head/w``
    ``tree["lm_head_w"]``."""
    parts = name.split("/")
    idx = None
    if parts[0] in ("layers", "enc_layers"):
        tree, idx, parts = tree[parts[0]], int(parts[1]), parts[2:]
    if parts[-1] == "scale":
        leaf = tree[parts[0]]
    elif parts == ["embed", "table"]:
        leaf = tree["embed"]["table"]
    elif len(parts) == 3:
        leaf = tree[parts[0]][f"{parts[1]}_{parts[2]}"]
    else:
        leaf = tree[f"{parts[0]}_{parts[1]}"]
    leaf = np.asarray(leaf)
    return leaf if idx is None else leaf[idx]


def test_config_matches_reference():
    assert ARCH in ALL_ARCHS
    for ref, port in ((ref_get_config(ARCH), get_config(ARCH)),
                      (ref_get_config(ARCH).reduced(),
                       get_config(ARCH).reduced())):
        for f in FIELDS:
            assert getattr(ref, f) == getattr(port, f), f
    w = get_config(ARCH)
    assert (w.n_layers, w.n_enc_layers, w.d_model, w.n_heads, w.n_kv, w.hd,
            w.d_ff, w.vocab, w.enc_len, w.qkv_bias) == (
        24, 24, 1024, 16, 16, 64, 4096, 51865, 1500, True)
    r = w.reduced()
    assert (r.n_layers, r.n_enc_layers, r.enc_len) == (2, 2, 24)
    assert w.hd in ops.FLASH_HEAD_DIMS


def test_batches_match_reference():
    for step_shard in ((0, 0), (1, 0), (0, 1)):
        port = SyntheticLM(_port_cfg(), DataConfig(seq_len=S, batch=3),
                           shard=step_shard[1])
        ref = RefSyntheticLM(_ref_cfg(), RefDataConfig(seq_len=S, batch=3),
                             shard=step_shard[1])
        for _ in range(step_shard[0] + 1):
            got, want = next(port), next(ref)
        assert set(got) == set(want) == {"tokens", "labels", "frames"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["frames"].shape == (3, 24, 256)


def _reference(cfg, data):
    """The reference's parameters, encoder output, prefill (logits and
    cache), two decode steps from the handed-off cache, and the step-0
    loss and gradients on ``data``."""
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = prog.init_params(0)
    inputs = {k: jnp.asarray(data[k]) for k in ("tokens", "frames")}
    logits, pf = prog.prefill_step(params, inputs)
    pf = jax.tree.map(np.asarray, pf)
    ref_attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = prog.fresh_cache()
    cache["layers"] = {k: v.at[:, :, :S].set(pf["layers"][k])
                       if k != "pos" else v.at[:, :S].set(pf["layers"][k])
                       for k, v in cache["layers"].items()}
    cache["cross"] = jnp.asarray(pf["cross"])
    cache["t"] = jnp.asarray(S, jnp.int32)
    tok = jnp.argmax(logits.astype(jnp.float32), axis=-1)[:, None]
    toks, lmax = [np.asarray(tok)[:, 0]], []
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(params, cache, tok)
        toks.append(np.asarray(tok)[:, 0])
        lmax.append(np.asarray(m))
    params = jax.tree.map(np.asarray, params)
    pj = jax.tree.map(jnp.asarray, params)     # unsharded, outside shard_map
    model = build_model(cfg, make_ctx(cfg, 1, 1))
    enc = model._encode(pj, inputs["frames"])
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(pj, jb)
    return {"params": params, "model": model,
            "enc": np.asarray(enc, np.float32),
            "logits": np.asarray(logits, np.float32), "cache": pf,
            "gen": np.stack(toks, 1), "lmax": np.stack(lmax),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def data():
    return next(iter(RefSyntheticLM(_ref_cfg(),
                                    RefDataConfig(seq_len=S, batch=B))))


@pytest.fixture(scope="module")
def ref_run(data):
    return _reference(_ref_cfg(), data)


def _program(run, mesh="1x1", dtype=torch.float32):
    prog = build_program(_port_cfg(dtype), mesh, device="cpu")
    prog.model.load_reference_params(run["params"])
    return prog


def _tensors(data) -> dict:
    return {"tokens": torch.as_tensor(data["tokens"]).long(),
            "labels": torch.as_tensor(data["labels"]).long(),
            "frames": torch.as_tensor(data["frames"])}


def test_encoder_prefill_and_decode_match_reference(ref_run, data):
    prog = _program(ref_run)
    model = prog.model
    bt = _tensors(data)
    with torch.inference_mode():
        enc = model.encode(bt["frames"])
    assert enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), ref_run["enc"], **TOL)
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    ops.reset_counts()
    logits, cache = prog.prefill_step({k: bt[k] for k in ("tokens", "frames")})
    cfg = model.cfg
    assert ops.PLAIN_CALLS["flash_fwd"] == cfg.n_enc_layers + 2 * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
    rc = ref_run["cache"]
    assert cache["t"] == S and len(cache["layers"]) == cfg.n_layers
    for i, c in enumerate(cache["layers"]):
        for j, kv in enumerate(("k", "v")):   # reference: [L, 2, B, T, KV, hd]
            want = rc["cross"][i, j]
            assert c["cross"][kv].shape == want.shape == (B, 24, 4, 64)
            np.testing.assert_allclose(c["cross"][kv].numpy(), want, **TOL,
                                       err_msg=f"cross cache {i} {kv}")
            np.testing.assert_allclose(c[kv].numpy(), rc["layers"][kv][i],
                                       **TOL, err_msg=f"cache {i} {kv}")
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = serve.handoff(prog, cache)
    assert cache["layers"][0]["k"].shape[1] == S + GEN
    tok = logits.float().argmax(-1)[:, None]
    toks, lmax = [tok[:, 0].numpy()], []
    ops.reset_counts()
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(cache, tok)
        toks.append(tok[:, 0].numpy())
        lmax.append(m.numpy())
    assert ops.PLAIN_CALLS["flash_fwd"] == GEN * cfg.n_layers
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)


def test_step0_loss_and_grads_match_reference(ref_run, data):
    model = _program(ref_run).model
    loss, metrics = model.train_loss(**_tensors(data))
    assert set(metrics) == {"loss"}
    loss.backward()
    assert abs(loss.item() - ref_run["loss"]) < 1e-4, (loss.item(),
                                                       ref_run["loss"])
    leaves = model.named_leaves()
    assert sum(p.numel() for _, p in leaves) == sum(
        a.size for a in jax.tree.leaves(ref_run["grads"]))
    names = {n for n, _ in leaves}
    assert {"enc_layers/1/ffn/up/b", "ln_enc/scale", "layers/1/lnx/scale",
            "layers/0/xattn/v/b", "layers/0/ffn/down/b"} <= names
    for name, p in leaves:
        want = ref_leaf(ref_run["grads"], name)
        scale = (ref_leaf(ref_run["grads"], name[:-1] + "w")
                 if name.endswith("/k/b") else want)
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(scale).max()) + 1e-9, err_msg=name)


def test_bf16_matches_reference_at_stated_tolerance(data):
    """The config's bf16: the encoder stays f32 (the reference's
    promotion), the cross K/V go to the kernel in bf16."""
    run = _reference(_ref_cfg(jnp.bfloat16), data)
    prog = _program(run, dtype=torch.bfloat16)
    model = prog.model
    assert model.layers[0].xattn.q.w.dtype == torch.bfloat16
    bt = _tensors(data)
    with torch.inference_mode():
        enc = model.encode(bt["frames"])
    assert enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), run["enc"], **TOL)
    logits, cache = model.prefill(bt["tokens"], frames=bt["frames"])
    assert cache["layers"][0]["cross"]["k"].dtype == torch.bfloat16
    got = logits.float().numpy()
    assert float(np.abs(run["logits"]).max()) > 1.0
    np.testing.assert_allclose(got, run["logits"], atol=BF16_LOGIT_TOL,
                               rtol=0)
    loss = model(**bt)
    assert abs(loss.item() - run["loss"]) < BF16_LOSS_TOL, (loss.item(),
                                                            run["loss"])


def test_trainer_2x1_step_matches_reference(ref_run, data):
    """Each of 2 ranks takes one row (and its frames); the step's loss is
    their mean, its grad norm that of their mean gradient."""
    model = ref_run["model"]
    params = jax.tree.map(jnp.asarray, ref_run["params"])
    losses, grads = [], []
    step = jax.jit(jax.value_and_grad(model.train_loss, has_aux=True))
    for w in range(2):
        half = {k: jnp.asarray(v[w:w + 1]) for k, v in data.items()}
        (loss, _), g = step(params, half)
        losses.append(float(loss))
        grads.append(g)
    gn = float(np.sqrt(sum(
        float(np.sum(((np.asarray(a, np.float64) + np.asarray(b)) / 2) ** 2))
        for a, b in zip(jax.tree.leaves(grads[0]),
                        jax.tree.leaves(grads[1])))))
    prog = _program(ref_run, mesh="2x1")
    attach_train(prog)
    m = prog.train_step(_tensors(data))
    assert abs(float(m["loss"]) - np.mean(losses)) < 1e-4, (m["loss"],
                                                            losses)
    np.testing.assert_allclose(float(m["grad_norm"]), gn, rtol=1e-4)
    assert float(m["sync/overflow"]) == 0
    assert float(m["sync/sparse_sent_words"]) > 0


def test_entry_points_run_on_cpu():
    ops.reset_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    cfg = get_config(ARCH).reduced()
    assert res["tokens"].shape == (2, 3)
    assert np.isfinite(res["logit_max"]).all()
    # prefill: the encoder's, self- and cross-attention; decode: cross
    assert res["plain_calls"]["flash_fwd"] == (
        cfg.n_enc_layers + 2 * cfg.n_layers + 2 * cfg.n_layers)
    assert not any(res["launches"].values())
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1", "--mesh", "2x1", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all() and out["overflow"] == 0
    assert out["sparse_words"] > 0


def test_serve_layers_cuts_the_encoder_too():
    """``launch/serve.py --layers 1`` keeps one decoder and one encoder
    layer: one plain ``flash_fwd`` each for the encoder, the self- and the
    cross-attention a prefill, one cross-attention a decode step."""
    ops.reset_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3",
                      "--layers", "1"])
    assert res["plain_calls"]["flash_fwd"] == 3 + 2
    assert np.isfinite(res["logit_max"]).all()
