"""Port parity: ``minicpm3-4b``'s MLA (multi-head latent attention).

* the port's config equals the reference's field by field, ``reduced()``
  included (2 layers, d 256, 4 / 4 heads, q/k 96 = 64 + rope 32, v 64,
  ranks 64 / 32), and ``configs.INPUT_SHAPES`` is the reference's table;
* the reduced model in f32 with the reference's parameters carried over
  (``Model.load_reference_params``), at ``tests/test_torch_zoo.py``'s
  tolerance (atol and rtol 1e-4): the prefill's last-position logits and
  its latent cache (``c``, ``kr``, ``pos`` of every layer), two greedy
  decode steps from the cache ``launch/serve.py::handoff`` makes (the
  same tokens, max logits within 1e-4), the step-0 loss, and every leaf's
  gradient (rtol 1e-4, atol 1e-4 of the leaf's largest); a prefill takes
  one plain ``flash_fwd`` a layer at q/k 96 and v 64;
* prefill followed by one decode step gives the logits of decoding the
  prompt token by token from an empty cache (1e-4), the reference's own
  cache-layout check (``tests/test_archs_smoke.py``);
* the same model in bf16 (the config's dtype): the prefill logits within
  the control, the gap between the reference's own bf16 and f32 logits on
  the same parameters (the port's bf16 model rounds at the same points,
  so it stays closer to the reference's bf16 model than bf16 is to f32);
  the loss within 1e-2;
* ``launch.serve`` and ``launch.train`` run the arch with ``--reduced
  --device cpu``, the trainer under ZeRO-1 (the default) and
  ``--no-zero1`` with the same losses.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch.mesh import make_mesh
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro.train.build import attach_serve as ref_attach_serve
from repro.train.build import build_program as ref_build_program
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models.attention import MLA
from repro_torch.train.build import attach_serve, build_program

ARCH = "minicpm3-4b"
B, S, GEN = 2, 12, 2
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_LOSS_TOL = 1e-2
FIELDS = ("name", "kind", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "vocab_padded", "hd", "head_dim", "qkv_bias",
          "rope_theta", "mla_q_rank", "mla_kv_rank", "mla_rope_dim",
          "mla_v_dim", "sliding_window", "source")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(dtype=jnp.float32):
    return dataclasses.replace(ref_get_config(ARCH).reduced(), dtype=dtype)


def _port_cfg(dtype=torch.float32):
    return dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)


def ref_leaf(tree, name: str) -> np.ndarray:
    """The reference's leaf under the port's name: ``layers/1/attn/q_up/w``
    is ``tree["layers"]["attn"]["q_up_w"][1]``, ``layers/0/attn/kv_norm/
    scale`` ``tree["layers"]["attn"]["kv_norm"][0]``, ``layers/0/ln1/
    scale`` ``tree["layers"]["ln1"][0]``, ``lm_head/w``
    ``tree["lm_head_w"]``."""
    parts = name.split("/")
    idx = None
    if parts[0] == "layers":
        tree, idx, parts = tree["layers"], int(parts[1]), parts[2:]
    if parts == ["embed", "table"]:
        leaf = tree["embed"]["table"]
    elif parts[-1] == "scale":
        for p in parts[:-1]:
            tree = tree[p]
        leaf = tree
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
    m = get_config(ARCH)
    assert (m.n_layers, m.d_model, m.n_heads, m.n_kv, m.hd, m.d_ff,
            m.vocab, m.mla_q_rank, m.mla_kv_rank, m.mla_rope_dim,
            m.mla_v_dim) == (62, 2560, 40, 40, 64, 6400, 73448, 768, 256,
                             32, 64)
    r = m.reduced()
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv, r.hd, r.mla_q_rank,
            r.mla_kv_rank, r.mla_rope_dim, r.mla_v_dim) == (
        2, 256, 4, 4, 64, 64, 32, 32, 64)
    # the kernel takes MLA's q/k and v widths
    assert (m.hd + m.mla_rope_dim, m.mla_v_dim) in ops.FLASH_HEAD_PAIRS
    assert INPUT_SHAPES == REF_INPUT_SHAPES


def _reference(cfg, data):
    """The reference's parameters, prefill (logits and latent cache), two
    decode steps from the handed-off cache, and the step-0 loss and
    gradients on ``data``."""
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = prog.init_params(0)
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
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                         jb)
    return {"params": params, "logits": np.asarray(logits, np.float32),
            "cache": pf, "gen": np.stack(toks, 1), "lmax": np.stack(lmax),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def data():
    return next(iter(RefSyntheticLM(_ref_cfg(),
                                    RefDataConfig(seq_len=S, batch=B))))


@pytest.fixture(scope="module")
def ref_run(data):
    return _reference(_ref_cfg(), data)


def _program(run, dtype=torch.float32):
    prog = build_program(_port_cfg(dtype), "1x1", device="cpu")
    prog.model.load_reference_params(run["params"])
    return prog


def _tensors(data) -> dict:
    return {k: torch.as_tensor(data[k]).long() for k in ("tokens", "labels")}


def test_prefill_latent_cache_and_decode_match_reference(ref_run, data):
    prog = _program(ref_run)
    model, cfg = prog.model, prog.model.cfg
    attn = model.layers[0].attn
    assert isinstance(attn, MLA)
    assert tuple(attn.q_up.w.shape) == (64, 4 * 96)
    assert tuple(attn.kv_up.w.shape) == (32, 4 * 128)
    assert tuple(attn.kv_down.w.shape) == (256, 32 + 32)
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    ops.reset_counts()
    logits, cache = prog.prefill_step({"tokens": _tensors(data)["tokens"]})
    assert ops.PLAIN_CALLS["flash_fwd"] == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
    rc = ref_run["cache"]["layers"]
    assert cache["t"] == S and len(cache["layers"]) == cfg.n_layers
    for i, c in enumerate(cache["layers"]):
        assert set(c) == {"c", "kr", "pos"}
        assert tuple(c["c"].shape) == (B, S, 32)
        assert tuple(c["kr"].shape) == (B, S, 32)
        for key in ("c", "kr"):
            np.testing.assert_allclose(c[key].numpy(), rc[key][i], **TOL,
                                       err_msg=f"layer {i} {key}")
        np.testing.assert_array_equal(c["pos"].numpy(), rc["pos"][i])
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = serve.handoff(prog, cache)
    assert cache["layers"][0]["c"].shape[1] == S + GEN
    tok = logits.float().argmax(-1)[:, None]
    toks, lmax = [tok[:, 0].numpy()], []
    ops.reset_counts()
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(cache, tok)
        toks.append(tok[:, 0].numpy())
        lmax.append(m.numpy())
    assert ops.PLAIN_CALLS["flash_fwd"] == 0    # decode: the latent einsums
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)


def test_prefill_then_decode_equals_decoding_the_prompt(ref_run, data):
    model = _program(ref_run).model
    tokens = _tensors(data)["tokens"]
    with torch.inference_mode():
        _, pf = model.prefill(tokens[:, :-1])
        cache = model.make_cache(B, S)
        for new, old in zip(cache["layers"], pf["layers"]):
            for key in ("c", "kr"):
                new[key][:, :S - 1] = old[key]
            new["pos"][:S - 1] = old["pos"]
        cache["t"] = S - 1
        _, m_pf, _ = model.decode(cache, tokens[:, -1:])
        step = model.make_cache(B, S)
        for i in range(S):
            _, m_dec, step = model.decode(step, tokens[:, i:i + 1])
    np.testing.assert_allclose(m_pf.numpy(), m_dec.numpy(), **TOL)
    for a, b in zip(cache["layers"], step["layers"]):
        for key in ("c", "kr"):
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), **TOL)
        np.testing.assert_array_equal(a["pos"].numpy(), b["pos"].numpy())


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
    assert {f"layers/1/attn/{k}" for k in (
        "q_down/w", "q_up/w", "kv_down/w", "kv_up/w", "o/w", "q_norm/scale",
        "kv_norm/scale")} <= names
    for name, p in leaves:
        want = ref_leaf(ref_run["grads"], name)
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()) + 1e-9, err_msg=name)


def test_bf16_matches_reference_within_the_bf16_control(ref_run, data):
    """The config's bf16 on the same parameters: the port's prefill logits
    no further from the reference's bf16 logits than those are from the
    reference's f32 ones (the control)."""
    run = _reference(_ref_cfg(jnp.bfloat16), data)
    control = float(np.abs(run["logits"] - ref_run["logits"]).max())
    model = _program(ref_run, dtype=torch.bfloat16).model
    assert model.layers[0].attn.kv_up.w.dtype == torch.bfloat16
    bt = _tensors(data)
    with torch.inference_mode():
        logits, cache = model.prefill(bt["tokens"])
    assert cache["layers"][0]["c"].dtype == torch.bfloat16
    gap = float(np.abs(logits.float().numpy() - run["logits"]).max())
    assert 0.0 < control and gap <= control, (gap, control)
    loss = model(bt["tokens"], bt["labels"])
    assert abs(loss.item() - run["loss"]) < BF16_LOSS_TOL, (loss.item(),
                                                            run["loss"])


def test_entry_points_run_on_cpu():
    ops.reset_counts()
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["plain_calls"]["flash_fwd"] == get_config(ARCH).reduced(
    ).n_layers
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "16",
            "--global-batch", "4", "--log-every", "1", "--mesh", "2x1",
            "--device", "cpu"]
    out = train.main(argv)
    assert np.isfinite(out["losses"]).all() and out["overflow"] == 0
    assert out["losses"] == train.main(argv + ["--no-zero1"])["losses"]
