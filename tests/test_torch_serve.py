"""Port parity: batched serving (prefill, then greedy decode) of reduced
``qwen2-0.5b`` and ``mamba2-370m`` in f32.

The reference's parameters (its threefry init) are loaded into the port
(``Model.load_reference_params``), and the same SyntheticLM prompt goes
through both:

* prefill's last-position logits agree within 1e-4 (f32; the attention and
  SSD scans sum in another order), and so does the cache it returns: k/v
  and positions for qwen2, the SSD state and conv tail for mamba2;
* from that cache, handed to a decode cache of S + 4 slots as
  ``launch/serve.py`` does, four greedy decode steps give the same tokens,
  with the max logit within 1e-4;
* the port's prefill then equals the port's decode of the whole prompt
  (the reference's ``test_prefill_matches_decode``);
* ``launch.serve --device cpu --reduced`` runs for both architectures on
  the kernels' plain versions, and without ``--device`` it raises here;
  ``launch.train`` trains the reduced Mamba2 LM on the CPU.
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
from repro.train.build import attach_serve as ref_attach_serve
from repro.train.build import build_program as ref_build_program
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models.model import Model
from repro_torch.train.build import attach_serve, build_program

ARCHS = ["qwen2-0.5b", "mamba2-370m"]
B, S, GEN = 2, 12, 4
TOL = dict(atol=1e-4, rtol=1e-4)


def _ref_cfg(arch):
    return dataclasses.replace(ref_get_config(arch).reduced(),
                               dtype=jnp.float32)


def _port_cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               dtype=torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def ref_run(request):
    """The reference's prefill and 4 decode steps from its cache."""
    arch = request.param
    cfg = _ref_cfg(arch)
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = prog.init_params(0)
    tokens = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=S,
                                                         batch=B))))["tokens"]
    logits, pf = prog.prefill_step(params, {"tokens": jnp.asarray(tokens)})
    pf = jax.tree.map(np.asarray, pf)
    ref_attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = prog.fresh_cache()
    if cfg.kind == "ssm":
        cache = jax.tree.map(jnp.asarray, pf)
    else:
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
    return {"arch": arch, "params": jax.tree.map(np.asarray, params),
            "tokens": tokens, "logits": np.asarray(logits, np.float32),
            "cache": pf, "gen": np.stack(toks, 1), "lmax": np.stack(lmax)}


def _port_model(run) -> Model:
    model = Model(_port_cfg(run["arch"]), device="cpu")
    model.load_reference_params(run["params"])
    return model


def _cache_pairs(cache: dict, ref_cache: dict):
    """(name, port array, reference array) for every cache leaf."""
    names = ("state", "conv") if "state" in cache["layers"][0] \
        else ("k", "v", "pos")
    for i, layer in enumerate(cache["layers"]):
        for n in names:
            yield f"layer {i} {n}", layer[n].numpy(), ref_cache["layers"][n][i]


def test_configs_match_reference():
    for arch in ARCHS:
        for ref, port in ((ref_get_config(arch), get_config(arch)),
                          (_ref_cfg(arch), _port_cfg(arch))):
            for f in ("kind", "n_layers", "d_model", "n_heads", "n_kv",
                      "vocab", "vocab_padded", "hd", "ssm_state",
                      "ssm_head_dim", "ssm_expand", "ssm_conv", "ssm_chunk",
                      "d_inner", "ssm_heads", "sliding_window", "source"):
                assert getattr(ref, f) == getattr(port, f), (arch, f)
    m = get_config("mamba2-370m")
    assert (m.n_layers, m.d_model, m.vocab, m.ssm_state, m.ssm_heads) == \
        (48, 1024, 50280, 128, 32)


def test_prefill_matches_reference(ref_run):
    model = _port_model(ref_run)
    logits, cache = model.prefill(torch.as_tensor(ref_run["tokens"]).long())
    np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
    assert cache["t"] == S == int(ref_run["cache"]["t"])
    for name, got, want in _cache_pairs(cache, ref_run["cache"]):
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_decode_steps_match_reference(ref_run):
    prog = build_program(_port_cfg(ref_run["arch"]), "1x1", device="cpu")
    prog.model.load_reference_params(ref_run["params"])
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    logits, cache = prog.prefill_step(
        {"tokens": torch.as_tensor(ref_run["tokens"]).long()})
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    cache = serve.handoff(prog, cache)
    tok = logits.float().argmax(-1)[:, None]
    toks, lmax = [tok[:, 0].numpy()], []
    for _ in range(GEN):
        tok, m, cache = prog.decode_step(cache, tok)
        toks.append(tok[:, 0].numpy())
        lmax.append(m.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)
    assert cache["t"] == S + GEN


def test_prefill_then_decode_equals_decode_of_prompt(ref_run):
    """Prefill's cache and last logits equal decoding the prompt token by
    token from an empty cache (cache-layout correctness)."""
    model = _port_model(ref_run)
    tokens = torch.as_tensor(ref_run["tokens"]).long()
    logits, pf = model.prefill(tokens)
    cache = model.make_cache(B, S)
    for i in range(S):
        _, m, cache = model.decode(cache, tokens[:, i:i + 1])
    torch.testing.assert_close(m, logits.float().max(-1).values, **TOL)
    assert cache["t"] == pf["t"] == S
    for a, b in zip(cache["layers"], pf["layers"]):
        for name in a:
            torch.testing.assert_close(a[name], b[name], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_on_cpu(arch):
    ops.reset_counts()
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    cfg = get_config(arch).reduced()
    assert res["tokens"].shape == (2, 3)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()
    assert np.isfinite(res["logit_max"]).all()
    assert (res["top2_gap"] >= 0).all()
    # the plain versions ran, one call per layer of the one prefill; no
    # kernel launched
    on_path = "ssd_fwd" if arch == "mamba2-370m" else "flash_fwd"
    assert res["plain_calls"][on_path] == cfg.n_layers
    assert sum(res["plain_calls"].values()) == cfg.n_layers
    assert not any(res["launches"].values())
    # the first new token is prefill's argmax
    np.testing.assert_array_equal(res["tokens"][:, 0],
                                  res["prefill_logits"].argmax(-1).numpy())


def test_serve_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-370m", "--reduced", "--gen", "2"])


def test_mamba2_trains_nowhere_yet():
    """The launcher trains the reduced Mamba2 LM on the CPU: a finite,
    falling loss, the scan's plain version in every layer's forward and in
    its recompute, and its plain recompute in every backward, no
    overflow."""
    steps, n_layers = 4, get_config("mamba2-370m").reduced().n_layers
    res = train.main(["--arch", "mamba2-370m", "--reduced", "--steps",
                      str(steps), "--log-every", "1", "--mesh", "2x1",
                      "--seq-len", "32", "--global-batch", "4",
                      "--device", "cpu"])
    losses = res["losses"]
    assert len(losses) == steps and np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert res["overflow"] == 0 and res["sparse_words"] > 0
    assert res["plain_calls"]["ssd_fwd"] == 2 * 2 * steps * n_layers
    assert not any(res["launches"].values())
