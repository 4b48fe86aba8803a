"""Port parity: the dense zoo configs ``qwen2.5-3b`` and ``phi4-mini-3.8b``.

* the port's configs equal the reference's field for field, ``source``
  included (and so do this slice's whisper-medium and pixtral-12b, with
  their encoder, patch and MLA fields, and minicpm3-4b's with its MLA
  ranks); phi4-mini's vocab of 200064 is a multiple of the 128-row pad;
* each at reduced depth and width (2 layers, d_model 256, vocab 512) that
  keeps what defines it: its q and KV head counts (GQA groups 8 and 3),
  the explicit head_dim 128, QKV bias on (qwen2.5-3b) or off
  (phi4-mini), its ``rope_theta`` (1e6, or the 10000 default phi4-mini
  leaves unset); in f32 with the reference's parameters carried over
  (``Model.load_reference_params``): prefill's last-position logits and
  two greedy decode steps within 1e-4 (tests/test_torch_serve.py's
  tolerance) and the step-0 loss within 1e-4 with its gradients within
  rtol 1e-4 (tests/test_torch_trainer.py's);
* ``launch.serve`` and ``launch.train`` run both archs on the CPU
  (``--reduced``), the trainer on a two-level topology.
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
from repro_torch.models.model import Model

ARCHS = ["qwen2.5-3b", "phi4-mini-3.8b"]
B, S, GEN = 2, 12, 2
TOL = dict(atol=1e-4, rtol=1e-4)
FIELDS = ("name", "kind", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "vocab_padded", "hd", "head_dim", "qkv_bias",
          "rope_theta", "sliding_window", "source")
# the enc_dec and vlm configs' further fields
NEW_ARCHS = ["whisper-medium", "pixtral-12b"]
NEW_FIELDS = FIELDS + ("n_enc_layers", "enc_len", "n_patches", "mla_q_rank",
                       "mla_kv_rank", "mla_rope_dim", "mla_v_dim")


def _small(cfg):
    """Reduced depth and width with the config's heads, head_dim, bias and
    rope_theta kept, in f32."""
    return dataclasses.replace(cfg, n_layers=2, d_model=256, d_ff=384,
                               vocab=512)


def _ref_cfg(arch):
    return dataclasses.replace(_small(ref_get_config(arch)),
                               dtype=jnp.float32)


def _port_cfg(arch):
    return dataclasses.replace(_small(get_config(arch)),
                               dtype=torch.float32)


def test_configs_match_reference():
    assert set(ARCHS) <= set(ALL_ARCHS)
    for arch in ARCHS:
        for ref, port in ((ref_get_config(arch), get_config(arch)),
                          (_ref_cfg(arch), _port_cfg(arch))):
            for f in FIELDS:
                assert getattr(ref, f) == getattr(port, f), (arch, f)
    q, p = get_config("qwen2.5-3b"), get_config("phi4-mini-3.8b")
    assert (q.n_heads // q.n_kv, q.hd, q.qkv_bias, q.rope_theta) == \
        (8, 128, True, 1e6)
    assert (p.n_heads // p.n_kv, p.hd, p.qkv_bias, p.rope_theta) == \
        (3, 128, False, 10_000.0)
    assert p.vocab == p.vocab_padded == 200064 == 1563 * 128
    for arch in NEW_ARCHS:
        for ref, port in ((ref_get_config(arch), get_config(arch)),
                          (ref_get_config(arch).reduced(),
                           get_config(arch).reduced())):
            for f in NEW_FIELDS:
                assert getattr(ref, f) == getattr(port, f), (arch, f)
    arch = "minicpm3-4b"
    assert arch in ALL_ARCHS
    for ref, port in ((ref_get_config(arch), get_config(arch)),
                      (ref_get_config(arch).reduced(),
                       get_config(arch).reduced())):
        for f in NEW_FIELDS:
            assert getattr(ref, f) == getattr(port, f), (arch, f)


@pytest.fixture(scope="module", params=ARCHS)
def ref_run(request):
    """The reference's parameters, prefill, two decode steps from its
    cache, and step-0 loss and gradients, on one SyntheticLM batch."""
    arch = request.param
    cfg = _ref_cfg(arch)
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = prog.init_params(0)
    data = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=S, batch=B))))
    logits, pf = prog.prefill_step(params,
                                   {"tokens": jnp.asarray(data["tokens"])})
    pf = jax.tree.map(np.asarray, pf)
    ref_attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = prog.fresh_cache()
    cache["layers"] = {k: v.at[:, :, :S].set(pf["layers"][k])
                       if k != "pos" else v.at[:, :S].set(pf["layers"][k])
                       for k, v in cache["layers"].items()}
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
    return {"arch": arch, "params": params,
            "data": data, "logits": np.asarray(logits, np.float32),
            "gen": np.stack(toks, 1), "lmax": np.stack(lmax),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


def _port_model(run) -> Model:
    model = Model(_port_cfg(run["arch"]), device="cpu")
    model.load_reference_params(run["params"])
    return model


def test_prefill_and_decode_match_reference(ref_run):
    model = _port_model(ref_run)
    cfg = model.cfg
    q = model.layers[0].attn
    assert (q.k.w.shape[-1], q.q.w.shape[-1]) == \
        (cfg.n_kv * 128, cfg.n_heads * 128)
    assert (q.q.b is not None) == cfg.qkv_bias
    with torch.inference_mode():
        logits, pf = model.prefill(
            torch.as_tensor(ref_run["data"]["tokens"]).long())
        np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
        cache = model.make_cache(B, S + GEN)
        for new, old in zip(cache["layers"], pf["layers"]):
            new["k"][:, :S] = old["k"]
            new["v"][:, :S] = old["v"]
            new["pos"][:S] = old["pos"]
        cache["t"] = S
        tok = logits.float().argmax(-1)[:, None]
        toks, lmax = [tok[:, 0].numpy()], []
        for _ in range(GEN):
            tok, m, cache = model.decode(cache, tok)
            toks.append(tok[:, 0].numpy())
            lmax.append(m.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)


def test_step0_loss_and_grads_match_reference(ref_run):
    model = _port_model(ref_run)
    data = ref_run["data"]
    loss = model(torch.as_tensor(data["tokens"]).long(),
                 torch.as_tensor(data["labels"]).long())
    loss.backward()
    assert abs(loss.item() - ref_run["loss"]) < 1e-4, (loss.item(),
                                                       ref_run["loss"])
    rg = ref_run["grads"]
    grads = dict((n, p.grad) for n, p in model.named_leaves())
    pairs = [("embed/table", rg["embed"]["table"]),
             ("lm_head/w", rg["lm_head_w"])]
    for i in range(model.cfg.n_layers):
        pairs += [(f"layers/{i}/attn/{k}/{s}",
                   rg["layers"]["attn"][f"{k}_{s}"][i])
                  for k in "qkvo" for s in "wb"
                  if f"{k}_{s}" in rg["layers"]["attn"]]
    for name, want in pairs:
        np.testing.assert_allclose(
            grads[name].numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()) + 1e-9, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_on_cpu(arch):
    ops.reset_counts()
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "2"])
    assert res["tokens"].shape == (2, 2)
    n_layers = get_config(arch).reduced().n_layers
    assert res["plain_calls"]["flash_fwd"] == n_layers
    out = train.main(["--arch", arch, "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1", "--mesh", "4x1", "--node-size",
                      "2", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all() and out["overflow"] == 0
    assert out["intra_words"][0] > 0 and out["inter_words"][0] > 0
