"""Port parity: the MoE FFN (``models/moe.py``) and the MoE decoders
``olmoe-1b-7b`` and ``phi3.5-moe-42b-a6.6b`` (``kind="moe"``).

* the port's configs equal the reference's field by field, ``source`` and
  ``reduced()`` included;
* routing from the same f32 router logits: the experts of every (token,
  k) pair, which pairs are kept, every pair's queue slot and the dispatch
  buffer's tokens (empty slots hold the sentinel T) bitwise the
  reference's routing (``src/repro/models/moe.py:60-85``), on logits with
  drops, with exact ties (the lower expert first, as ``lax.top_k``) and at
  olmoe's decode shape (T = 8: cap 2); the gates within 1e-6;
* the MoE layer (``moe_ffn_replicated``) on one-hot token rows, whose
  router logits are the router's rows exactly on both sides: the stats
  ``moe/dropped`` and ``moe/skew`` and the expert shares f_e exact (a case
  with drops), ``moe/aux_loss`` within 1e-6 and the output within 1e-5;
  on random rows the output within 1e-5 (the combine adds a token's K
  outputs in another order);
* each model at 2 layers and d_model 256 that keeps its experts, top-K,
  q / KV heads and head_dim (olmoe 64 experts top-8, 16 / 16 heads;
  phi3.5-moe 16 top-2, 32 / 8; head_dim 128), in f32 with the reference's
  parameters carried over: prefill's last-position logits and two greedy
  decode steps (T = B = 2 tokens a step: cap 1 for olmoe) within 1e-4; the
  step-0 loss (with the 0.01-weighted aux term) and the ``loss`` metric
  (without it) within 1e-4, the layers' mean MoE stats too, every leaf's
  gradient within rtol 1e-4 (atol 1e-4 of its largest); the train step's
  metrics carry ``loss`` and ``moe/*`` as the reference's step does;
* ``launch.serve`` and ``launch.train`` run both archs with ``--reduced
  --device cpu``, the trainer logging ``moe/*``.
"""
import dataclasses
import functools
import math

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
from repro.models.model import AUX_LOSS_W as REF_AUX_LOSS_W
from repro.models.model import build_model
from repro.models.moe import moe_ffn_replicated
from repro.train.build import attach_serve as ref_attach_serve
from repro.train.build import build_program as ref_build_program
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models.model import AUX_LOSS_W, Model
from repro_torch.models.moe import MoE, capacity, expert_share, route
from repro_torch.train.build import attach_train, build_program

ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
B, S, GEN = 2, 12, 2
TOL = dict(atol=1e-4, rtol=1e-4)
FIELDS = ("name", "kind", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
          "vocab", "vocab_padded", "hd", "head_dim", "qkv_bias",
          "rope_theta", "n_experts", "top_k", "capacity_factor",
          "shared_attn_every", "sliding_window", "source")
STATS = ("moe/aux_loss", "moe/dropped", "moe/skew")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small ops: a pool of threads
    in each test worker only contends with the other workers' pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_configs_match_reference():
    assert set(ARCHS) <= set(ALL_ARCHS)
    for arch in ARCHS:
        for ref, port in ((ref_get_config(arch), get_config(arch)),
                          (ref_get_config(arch).reduced(),
                           get_config(arch).reduced()),
                          (_ref_cfg(arch), _port_cfg(arch))):
            for f in FIELDS:
                assert getattr(ref, f) == getattr(port, f), (arch, f)
    o, p = get_config("olmoe-1b-7b"), get_config("phi3.5-moe-42b-a6.6b")
    assert (o.n_layers, o.d_model, o.n_heads, o.n_kv, o.hd, o.d_ff, o.vocab,
            o.n_experts, o.top_k) == (16, 2048, 16, 16, 128, 1024, 50304,
                                      64, 8)
    assert (p.n_layers, p.d_model, p.n_heads, p.n_kv, p.hd, p.d_ff, p.vocab,
            p.n_experts, p.top_k) == (32, 4096, 32, 8, 128, 6400, 32064, 16,
                                      2)
    assert o.hd in ops.FLASH_HEAD_DIMS and p.hd in ops.FLASH_HEAD_DIMS
    # at decode T = B: olmoe at batch 8 keeps 2 pairs an expert
    assert capacity(8, o) == 2 and capacity(8 * 512, o) == 640


# ---------------------------------------------------------------------------
# routing and the MoE layer
# ---------------------------------------------------------------------------

def _ref_route(logits, K: int, cap: int) -> dict:
    """The reference's routing and dispatch (``moe_ffn_replicated``,
    src/repro/models/moe.py:60-85, at tp = 1) on given f32 logits."""
    T, E = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gate, eidx = jax.lax.top_k(probs, K)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    flat_e = eidx.reshape(T * K)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = jnp.arange(T * K) - jnp.searchsorted(sorted_e, sorted_e,
                                                    side="left")
    rank_in_e = jnp.zeros(T * K, jnp.int32).at[order].set(
        pos_in_e.astype(jnp.int32))
    keep = rank_in_e < cap
    slot = flat_e * cap + rank_in_e
    tok_of = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    buf_tok = jnp.full((E * cap,), T, jnp.int32).at[
        jnp.where(keep, slot, E * cap)].set(tok_of, mode="drop")
    f_e = jnp.zeros((E,), jnp.float32).at[eidx.reshape(-1)].add(1.0) / T
    return {k: np.asarray(v) for k, v in dict(
        gate=gate, eidx=eidx, keep=keep, slot=slot, buf_tok=buf_tok,
        f_e=f_e).items()}


def _logit_cases():
    rng = np.random.default_rng(0)
    skewed = rng.standard_normal((48, 8)).astype(np.float32)
    skewed[:, 0] += 1.5                   # expert 0 overflows its queue
    ties = rng.integers(0, 3, (40, 8)).astype(np.float32)
    decode = rng.standard_normal((8, 64)).astype(np.float32)
    return [("skewed", skewed, 2), ("ties", ties, 2), ("decode", decode, 8)]


@pytest.mark.parametrize("name,logits,K", _logit_cases(),
                         ids=[c[0] for c in _logit_cases()])
def test_routing_matches_reference_bitwise(name, logits, K):
    T, E = logits.shape
    cap = max(1, int(math.ceil(T * K / E * 1.25)))
    want = _ref_route(logits, K, cap)
    got = route(torch.from_numpy(logits), K, cap)
    np.testing.assert_array_equal(got["eidx"].numpy(), want["eidx"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    pos = got["pair_of_slot"].numpy()       # the pair a slot holds
    np.testing.assert_array_equal(np.where(pos == T * K, T, pos // K),
                                  want["buf_tok"])
    np.testing.assert_array_equal(expert_share(got["eidx"], E).numpy(),
                                  want["f_e"])
    np.testing.assert_allclose(got["gate"].numpy(), want["gate"], atol=1e-6,
                               rtol=0)
    assert (want["buf_tok"] == T).any()               # empty slots
    if name != "ties":
        assert not want["keep"].all()                 # drops
    else:   # ties break toward the lower expert, as lax.top_k does
        eq = logits[np.arange(T), want["eidx"][:, 0]] == \
            logits[np.arange(T), want["eidx"][:, 1]]
        assert eq.any()
        assert (want["eidx"][eq, 0] < want["eidx"][eq, 1]).all()


def _layer_cfgs():
    """A small MoE config (d 64, f 96, 8 experts top-2), f32."""
    kw = dict(n_layers=1, d_model=64, d_ff=96, n_heads=4, n_kv=4,
              head_dim=16, n_experts=8, top_k=2, vocab=512)
    return (dataclasses.replace(ref_get_config("olmoe-1b-7b"),
                                dtype=jnp.float32, **kw),
            dataclasses.replace(get_config("olmoe-1b-7b"),
                                dtype=torch.float32, **kw))


@pytest.mark.parametrize("rows", ["one-hot", "random"])
def test_moe_layer_matches_reference(rows):
    rcfg, pcfg = _layer_cfgs()
    layer = MoE(pcfg, device="cpu", gen=torch.Generator().manual_seed(1))
    with torch.no_grad():   # skew the router so expert 0 overflows
        layer.router_w[:, 0] += 0.4
    x = np.zeros((2, 16, 64), np.float32)
    if rows == "one-hot":   # x @ router_w is router_w's rows, exactly
        x.reshape(32, 64)[np.arange(32), np.arange(32)] = 1.0
    else:
        x = np.random.default_rng(2).standard_normal(x.shape).astype(
            np.float32)
    p = {"ffn": {k: jnp.asarray(getattr(layer, k).detach().numpy())
                 for k in ("router_w", "w_gate", "w_up", "w_down")}}
    want, wst = jax.jit(lambda p, x: moe_ffn_replicated(
        p, "ffn", x, rcfg, make_ctx(rcfg, 1, 1)))(p, jnp.asarray(x))
    got, gst = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    assert float(wst["moe/dropped"]) > 0
    if rows == "one-hot":
        for k in ("moe/dropped", "moe/skew"):
            assert float(gst[k]) == float(wst[k]), k
    np.testing.assert_allclose(float(gst["moe/aux_loss"].detach()),
                               float(wst["moe/aux_loss"]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _small(cfg):
    """2 layers, d_model 256, d_ff 384, vocab 512; experts, top-K, heads
    and head_dim kept."""
    return dataclasses.replace(cfg, n_layers=2, d_model=256, d_ff=384,
                               vocab=512)


def _ref_cfg(arch):
    return dataclasses.replace(_small(ref_get_config(arch)),
                               dtype=jnp.float32)


def _port_cfg(arch):
    return dataclasses.replace(_small(get_config(arch)), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's seed-0 parameters of ``arch``'s small config, made
    once for the module (its serving and its trainer case share them)."""
    prog = ref_build_program(_ref_cfg(arch),
                             make_mesh((1, 1), ("data", "model")))
    return prog.init_params(0)


@pytest.fixture(scope="module", params=ARCHS)
def ref_run(request):
    """The reference's parameters, prefill, two decode steps from its
    cache, and the step-0 loss, metrics and gradients."""
    arch = request.param
    cfg = _ref_cfg(arch)
    prog = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")))
    ref_attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    params = _ref_params(arch)
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
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                         jb)
    return {"arch": arch, "params": params, "data": data,
            "logits": np.asarray(logits, np.float32),
            "gen": np.stack(toks, 1), "lmax": np.stack(lmax),
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads)}


def _port_model(run) -> Model:
    model = Model(_port_cfg(run["arch"]), device="cpu")
    model.load_reference_params(run["params"])
    return model


def test_prefill_and_decode_match_reference(ref_run):
    prog = build_program(_port_cfg(ref_run["arch"]), "1x1", device="cpu")
    prog.model.load_reference_params(ref_run["params"])
    cfg = prog.cfg
    ffn = prog.model.layers[0].ffn
    assert tuple(ffn.w_gate.shape) == (cfg.n_experts, 256, 384)
    assert prog.model.layers[0].attn.q.w.shape[-1] == cfg.n_heads * 128
    ops.reset_counts()
    logits, cache = prog.model.prefill(
        torch.as_tensor(ref_run["data"]["tokens"]).long())
    assert ops.PLAIN_CALLS["flash_fwd"] == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref_run["logits"], **TOL)
    prog.cache_specs = {"batch": B, "window": 0, "cache_len": S + GEN}
    cache = serve.handoff(prog, cache)
    tok = logits.float().argmax(-1)[:, None]
    toks, lmax = [tok[:, 0].numpy()], []
    for _ in range(GEN):
        tok, m, cache = prog.model.decode(cache, tok)
        toks.append(tok[:, 0].numpy())
        lmax.append(m.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), ref_run["gen"])
    np.testing.assert_allclose(np.stack(lmax), ref_run["lmax"], **TOL)


def test_step0_loss_and_grads_match_reference(ref_run):
    model = _port_model(ref_run)
    data = ref_run["data"]
    loss, metrics = model.train_loss(torch.as_tensor(data["tokens"]).long(),
                                     torch.as_tensor(data["labels"]).long())
    loss.backward()
    want = ref_run["metrics"]
    assert AUX_LOSS_W == REF_AUX_LOSS_W == 0.01
    assert abs(loss.item() - ref_run["loss"]) < 1e-4, (loss.item(),
                                                       ref_run["loss"])
    # the loss metric is the LM loss, before the aux term
    assert set(metrics) == {"loss", *STATS} == set(want)
    assert abs(metrics["loss"].item() - want["loss"]) < 1e-4
    assert loss.item() == pytest.approx(
        metrics["loss"].item() + AUX_LOSS_W * metrics["moe/aux_loss"].item(),
        abs=1e-6)
    for k in STATS:
        assert abs(metrics[k].item() - want[k]) < 1e-4, k
    rg = ref_run["grads"]
    grads = {n: p.grad for n, p in model.named_leaves()}
    pairs = {"embed/table": rg["embed"]["table"], "lm_head/w": rg["lm_head_w"],
             "ln_f/scale": rg["ln_f"]}
    ly = rg["layers"]
    for i in range(model.cfg.n_layers):
        pre = f"layers/{i}/"
        pairs.update({pre + "ln1/scale": ly["ln1"][i],
                      pre + "ln2/scale": ly["ln2"][i]})
        pairs.update({pre + f"attn/{k}/w": ly["attn"][f"{k}_w"][i]
                      for k in "qkvo"})
        pairs.update({pre + f"ffn/{k}": ly["ffn"][k][i]
                      for k in ("router_w", "w_gate", "w_up", "w_down")})
    assert set(pairs) == set(grads)
    for name, want_g in pairs.items():
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(
            grads[name].numpy(), want_g, rtol=1e-4,
            atol=1e-4 * float(np.abs(want_g).max()) + 1e-9, err_msg=name)


def test_train_step_metrics_carry_the_moe_stats(ref_run):
    prog = build_program(_port_cfg(ref_run["arch"]), "1x1", device="cpu")
    prog.model.load_reference_params(ref_run["params"])
    attach_train(prog)
    data = ref_run["data"]
    m = prog.train_step({k: torch.as_tensor(v).long()
                         for k, v in data.items()})
    want = ref_run["metrics"]
    for k in ("loss", *STATS):
        assert abs(float(m[k]) - want[k]) < 1e-4, k
    assert float(m["sync/overflow"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_on_cpu(arch):
    ops.reset_counts()
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--gen", "3"])
    cfg = get_config(arch).reduced()
    assert res["tokens"].shape == (2, 3)
    assert np.isfinite(res["logit_max"]).all()
    assert res["plain_calls"] == {"flash_fwd": cfg.n_layers, "ssd_fwd": 0}
    assert not any(res["launches"].values())
    out = train.main(["--arch", arch, "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1", "--mesh", "2x1", "--device", "cpu"])
    assert np.isfinite(out["losses"]).all() and out["overflow"] == 0
    assert set(out["moe"]) == set(STATS)
    for k in STATS:
        assert len(out["moe"][k]) == 2 and np.isfinite(out["moe"][k]).all()
    assert all(0 <= v <= 1 for v in out["moe"]["moe/dropped"])
    assert all(v >= 1 for v in out["moe"]["moe/skew"])


def test_trainer_steps_match_reference():
    """Three steps of the port's trainer on olmoe's small config within
    1e-3 of the reference's on one repeated batch (tests/test_torch_
    trainer.py's gate): the aux loss's gradient, the router's and the
    experts' updates carried through the optimizer.  Both at 1x1: the
    capacity, and so which pairs drop, depends on the tokens a rank
    routes, so an MoE step is not the same function of the global batch
    on another number of data-parallel ranks."""
    from repro.core.zen import SyncConfig as RefSyncConfig
    from repro.train.build import attach_train as ref_attach_train
    from repro.train.steps import TrainerConfig as RefTrainerConfig
    from repro_torch.core.zen import SyncConfig
    from repro_torch.train.steps import TrainerConfig

    arch, steps, seq, batch = "olmoe-1b-7b", 3, 16, 4
    cfg = _ref_cfg(arch)
    ref = ref_build_program(cfg, make_mesh((1, 1), ("data", "model")),
                            RefTrainerConfig(sync=RefSyncConfig(
                                scheme="dense")))
    ref_attach_train(ref, seq_len=seq, global_batch=batch)
    params = _ref_params(arch)
    data = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=seq,
                                                       batch=batch))))
    port = build_program(_port_cfg(arch), "1x1",
                         TrainerConfig(sync=SyncConfig(scheme="dense")),
                         device="cpu")
    port.model.load_reference_params(jax.tree.map(np.asarray, params))
    attach_train(port)
    opt = ref.init_opt(params)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.as_tensor(v).long() for k, v in data.items()}
    got, want = [], []
    for _ in range(steps):
        params, opt, m = ref.train_step(params, opt, jb)
        want.append(float(m["loss"]))
        got.append(float(port.train_step(tb)["loss"]))
    assert np.max(np.abs(np.array(got) - np.array(want))) < 1e-3, (got,
                                                                   want)
