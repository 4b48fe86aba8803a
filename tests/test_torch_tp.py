"""Tensor parallelism of the port (``--mesh DxM``, M = 2) for the dense
decoder: qwen2-0.5b reduced, f32, against the reference and the port's own
1x1 run.

Two gloo groups of ``tests/torch_tp_rank.py`` processes run at once, a 2x2
mesh of four and a 1x2 mesh of two, with the launcher's own 2x2 run under
``torchrun`` and the reference's runs (``tests/torch_tp_reference.py``, 4
forced host devices) beside them; this process builds the reference's and
the port's 1x1 results meanwhile.

* in-process: the port's per-leaf shard table (``Model.shard_dims``) is
  the reference's ``model.abstract()`` specs at tp = 2 for all ten
  configs' reduced variants; ``make_ctx`` and ``validate_tp`` agree with
  the reference's (``shard_heads``, ``h_pad``, the config-named errors);
  ``cache_write`` fills the round-robin ring as the reference's does;
* weights: each model rank's shard after ``load_reference_params`` is
  bitwise the reference's shard on that rank's devices at (2, 2); a
  seed-0 build's shards, gathered over the 2x2 ranks, are bitwise the
  port's 1x1 build;
* forward: the step-0 loss at 1x2 and 2x2 within 1e-6 of the reference's
  at the same mesh;
* gradients at 1x2, every leaf gathered to its global shape, within 1e-5
  max|g| of the port's 1x1 gradient and of the reference's; the
  reference's ``grad_norm`` at (1, 2) is twice its (1, 1) value, the
  port's is the (1, 1) value; 2 SGD steps without a clip at 1x2 within
  1e-5 of the port's 1x1 losses;
* the 2x2 trainer (Zen with the reference's hash seeds): 4 AdamW steps
  within 1e-3 of the reference's at (2, 2); each model rank's
  ``sync/sparse_sent_words`` and ``sync/overflow`` bitwise the
  reference's on its devices, the reported words their mean; ZeRO-1's
  parameters bitwise the full update's, each process holding 1 / D of its
  shard's moments;
* serving at 1x2: each rank's prefill cache (k, v, pos) within
  ``CACHE_TOL`` = 1e-5 of the largest value of the reference's shard on
  that device, the gathered logits within 1e-5, and 8 greedy tokens
  equal to the reference's at (1, 1) and to the port's 1x1 (and with
  the decode cache whole on every rank, ``decode_seq_shard`` off); the
  reference's own (1, 2) decode parts from them (it mixes heads, ROADMAP
  queue 3), which one case records;
* a checkpoint saved and restored at 2x2 continues bit for bit;
* ``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2
  --dist gloo --device cpu`` trains, each rank running the Zen route
  once a step, its step-0 loss within 1e-2 (bf16) of the 1x1 run's.
"""
import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.core.zen import SyncConfig as RefSyncConfig
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import layers as ref_layers
from repro.models.common import make_ctx as ref_make_ctx
from repro.models.model import build_model
from repro.train.steps import TrainerConfig as RefTrainerConfig
from repro.train.steps import make_gradsync as ref_make_gradsync
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch import serve, train
from repro_torch.models import layers
from repro_torch.models.common import ShardCtx, make_ctx
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import steps as st
from repro_torch.train.build import attach_serve, attach_train, build_program
from repro_torch.train.steps import TrainerConfig
from test_torch_dist import _env, _free_port, _Procs
from torch_tp_rank import GEN

HERE = Path(__file__).resolve().parent
RANK_MAIN, REF_MAIN = HERE / "torch_tp_rank.py", HERE / "torch_tp_reference.py"
SEQ, BATCH, PROMPT, PROMPT_BATCH = 32, 4, 16, 2
ARCH = "qwen2-0.5b"
# the prefill cache's gate, a share of its largest value: the port's own
# 1x1 cache is 1.0e-6 of it from the reference's 1x1 after one layer
# (3.6e-6 at values up to 3.6: the two libraries order their f32 sums
# differently), so an absolute 1e-6 fails at 1x1 already
CACHE_TOL = 1e-5
CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
       "--seq-len", "32", "--global-batch", "4", "--log-every", "1"]


def ref_cfg(arch: str = ARCH):
    cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                              dtype=jnp.float32)
    return (dataclasses.replace(cfg, capacity_factor=4.0)
            if cfg.kind == "moe" else cfg)


def port_cfg(arch: str = ARCH):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.float32)
    return (dataclasses.replace(cfg, capacity_factor=4.0)
            if cfg.kind == "moe" else cfg)


def stub_group(rank: int = 0, n: int = 2):
    """A model group stand-in for code that asks only for the rank."""
    return types.SimpleNamespace(ranks=(rank,), n=n, pg=None)


class RankGroup(_Procs):
    """``n`` ranks of ``torch_tp_rank.py`` on ``work/inputs.npz``."""

    def __init__(self, work: Path, n: int, jobs: list[str]):
        port = str(_free_port())
        super().__init__(work, [
            ([sys.executable, str(RANK_MAIN), str(work), *jobs],
             _env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                  LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=port)) for r in range(n)])
        self.n = n

    def results(self) -> list[dict]:
        rcs = self.wait()
        if any(rcs):
            pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(
                self.log(i)[-3000:] for i in range(self.n)))
        return [dict(np.load(self.work / f"rank{r}.npz"))
                for r in range(self.n)]


class Reference(_Procs):
    """``torch_tp_reference.py`` in a process of its own (``what``: its
    arguments after the output file)."""

    def __init__(self, work: Path, *what: str):
        super().__init__(work, [([sys.executable, str(REF_MAIN),
                                  str(work / "ref.npz"), *what], _env())])

    def results(self) -> dict:
        if self.wait()[0]:
            pytest.fail(f"the reference's runs failed:\n{self.log(0)[-4000:]}")
        return dict(np.load(self.work / "ref.npz"))


def reference_inputs(arch: str, tmp_path_factory) -> tuple[dict, dict]:
    """The reference's global params (1 device, seed 0), flattened, the
    batch and the prompt; and the params' pytree."""
    cfg = ref_cfg(arch)
    params = build_model(cfg, ref_make_ctx(cfg, 1, 1)).init(
        jax.random.PRNGKey(0))[0]
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    batch = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=SEQ,
                                                        batch=BATCH))))
    prompt = next(iter(RefSyntheticLM(cfg, RefDataConfig(
        seq_len=PROMPT, batch=PROMPT_BATCH))))["tokens"]
    inp = {**flat, "arch": arch, "serve/tokens": prompt,
           **{f"batch/{k}": v for k, v in batch.items()}}
    return inp, params


def start(arch: str, jobs4: list[str], jobs2: list[str], what: str,
          tmp_path_factory, extra: dict | None = None) -> dict:
    """Write the inputs, start the 2x2 and 1x2 groups and the reference."""
    inp, params = reference_inputs(arch, tmp_path_factory)
    inp.update(extra or {})
    out = {"inp": inp, "params": params}
    for n, jobs in ((4, jobs4), (2, jobs2)):
        work = tmp_path_factory.mktemp(f"tp{n}")
        np.savez(work / "inputs.npz", **inp)
        out[n] = RankGroup(work, n, jobs)
    out["ref"] = Reference(tmp_path_factory.mktemp("ref"), what)
    return out


def zen_seeds(arch: str = ARCH) -> np.ndarray:
    """The reference GradSync's hash seeds for ``embed/table``'s [Vp/2, d]
    shard at mesh (2, 2) (its layouts are built offline)."""
    cfg = ref_cfg(arch)
    model = build_model(cfg, ref_make_ctx(cfg, 2, 2))
    shapes, specs = model.abstract()
    gs = ref_make_gradsync(model, RefTrainerConfig(
        sync=RefSyncConfig(scheme="zen")), specs, shapes)
    return gs._layouts["embed/table", 0].seeds


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every process of the module, started at once; stopped at its end."""
    out = start(ARCH, ["weights", "trainer", "ckpt"], ["grads", "sgd",
                                                       "serve"],
                "dense", tmp_path_factory, {"zen_seeds": zen_seeds()})
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "4", "-m", "repro_torch.launch.train"]
    out["cli"] = _Procs(tmp_path_factory.mktemp("cli"), [
        ([*torchrun, *CLI, "--mesh", "2x2", "--dist", "gloo"], _env())])
    yield out
    for procs in (out[4], out[2], out["ref"], out["cli"]):
        procs.kill()


def port_model(params, **kw) -> Model:
    model = Model(port_cfg(), device="cpu", **kw)
    model.load_reference_params(jax.tree.map(np.asarray, params))
    return model


def torch_batch(inp: dict) -> dict:
    return {k: torch.from_numpy(inp[f"batch/{k}"]).long()
            for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# in-process: the shard table, make_ctx, cache_write
# ---------------------------------------------------------------------------

def spec_tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shard_table_matches_reference_specs(arch):
    rcfg = ref_get_config(arch).reduced()
    _, specs = build_model(rcfg, ref_make_ctx(rcfg, 2, 1)).abstract()
    cfg = get_config(arch).reduced()
    ctx = make_ctx(cfg, 2, 1, group=stub_group())
    model = Model(cfg, device="cpu")
    dims = model.shard_dims(ctx)
    leaves = model.reference_leaves()
    n_ref = len(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)))
    # every reference leaf (its stacked layers are one) and every port leaf
    assert len({path for _, path, _ in leaves}) == n_ref
    assert len(leaves) == len(dims) == len(model.named_leaves())
    for name, path, idx in leaves:
        spec = tuple(spec_tree_get(specs, path))[len(idx):]
        want = spec.index("model") if "model" in spec else None
        assert dims[name] == want, (name, path, spec)


CTX_CASES = [("qwen2-0.5b", 2, False), ("qwen2-0.5b", 4, False),
             ("qwen2-0.5b", 4, True), ("phi4-mini-3.8b", 16, True),
             ("olmoe-1b-7b", 2, False), ("qwen2-0.5b", 3, False),
             ("olmoe-1b-7b", 128, False), ("mamba2-370m", 64, False),
             ("qwen2.5-3b", 32, False), ("minicpm3-4b", 16, True)]


@pytest.mark.parametrize("arch,tp,pad", CTX_CASES)
def test_make_ctx_matches_reference(arch, tp, pad):
    ref_err = port_err = None
    try:
        ref = ref_make_ctx(ref_get_config(arch), tp, 1, pad_heads=pad)
    except ValueError as e:
        ref_err = str(e)
    try:
        got = make_ctx(get_config(arch), tp, 1, pad_heads=pad,
                       group=stub_group(n=tp))
    except ValueError as e:
        port_err = str(e)
    assert port_err == ref_err
    if ref_err is None:
        assert (got.shard_heads, got.h_pad) == (ref.shard_heads, ref.h_pad)


def test_cache_write_round_robin_ring_matches_reference():
    """Positions 0..13 written into 3 slots a rank at tp = 2 (a ring: the
    window bounds the cache): each rank holds the reference's K, V and
    positions after every write."""
    cfg = ref_cfg()
    rctx = ref_make_ctx(cfg, 2, 1)
    rng = np.random.default_rng(0)
    B, Sl, KV, hd = 2, 3, 2, 4
    new = rng.standard_normal((14, 2, B, KV, hd)).astype(np.float32)

    def ref_write(k, v, pos, kn, vn, t):
        return ref_layers.cache_write(k, v, pos, kn, vn, t, rctx)

    rk = jnp.zeros((2, B, Sl, KV, hd))
    rv, rpos = jnp.zeros_like(rk), jnp.full((2, Sl), -1, jnp.int32)
    port = [{"k": torch.zeros(B, Sl, KV, hd), "v": torch.zeros(B, Sl, KV, hd),
             "pos": torch.full((Sl,), -1, dtype=torch.int32)}
            for _ in range(2)]
    for t in range(14):
        kn, vn = (jnp.broadcast_to(new[t, i], (2, B, KV, hd)) for i in (0, 1))
        rk, rv, rpos = jax.vmap(ref_write, in_axes=(0, 0, 0, 0, 0, None),
                                axis_name="model")(rk, rv, rpos, kn, vn, t)
        for r, c in enumerate(port):
            layers.cache_write(c["k"], c["v"], c["pos"],
                               torch.from_numpy(new[t, 0]),
                               torch.from_numpy(new[t, 1]), t,
                               ShardCtx(tp=2, group=stub_group(r)))
            for key, want in (("k", rk), ("v", rv), ("pos", rpos)):
                np.testing.assert_array_equal(c[key].numpy(),
                                              np.asarray(want[r]), key)
    # the last ring holds positions 8..13: rank 0 the even ones
    assert port[0]["pos"].tolist() == [12, 8, 10]
    assert port[1]["pos"].tolist() == [13, 9, 11]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_weights_are_the_reference_shards(groups):
    """The reference's (2, 2) parameters, gathered, loaded by each model
    rank's build (the rank given by a stand-in group: loading runs no
    collective): every leaf bitwise the reference's shard on the devices
    of that model index.  (The reference's (2, 2) init is not bitwise its
    1-device init here: a quarter of ``embed/table``'s elements differ by
    an ulp, so the shards are held against the (2, 2) init's own.)  A
    seed-0 build's shards, gathered over the 2x2 ranks' model groups, are
    bitwise the port's 1x1 build."""
    ref = groups["ref"].results()
    tree = {}
    for key in ref:
        if key.startswith("p22/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
    cfg = port_cfg()
    for m in range(2):
        model = Model(cfg, device="cpu",
                      ctx=make_ctx(cfg, 2, 2, group=stub_group(m)))
        model.load_reference_params(tree)
        params = dict(model.named_leaves())
        for name, path, idx in model.reference_leaves():
            for d in range(2):
                want = ref[f"shard/{'/'.join(path)}/d{d}m{m}"]
                want = want[idx] if idx else want
                np.testing.assert_array_equal(params[name].detach().numpy(),
                                              want, f"model rank {m} {name}")
    seed0 = Model(cfg, device="cpu", seed=0)
    for res in groups[4].results():
        for name, p in seed0.named_leaves():
            np.testing.assert_array_equal(res[f"seed0/{name}"],
                                          p.detach().numpy(), name)


def test_padded_heads_are_the_reference_shards():
    """``pad_heads`` at tp = 4 on a 6-head variant of the reduced config
    (heads padded to 8, 2 a rank): each model rank's shards after
    ``load_reference_params`` are slices of the reference's padded global
    leaves (its q columns and o rows of the padded heads zero), and the
    port's own build zeroes the same columns and rows."""
    rcfg = dataclasses.replace(ref_cfg(), n_heads=6)
    cfg = dataclasses.replace(port_cfg(), n_heads=6)
    rctx = ref_make_ctx(rcfg, 4, 1, pad_heads=True)
    assert (rctx.h_pad, rctx.shard_heads) == (8, True)
    tree = jax.tree.map(np.asarray, build_model(rcfg, rctx).init(
        jax.random.PRNGKey(0))[0])
    hd = cfg.hd
    for m in range(4):
        ctx = make_ctx(cfg, 4, 1, pad_heads=True, group=stub_group(m, 4))
        assert (ctx.h_pad, ctx.shard_heads) == (8, True)
        model = Model(cfg, device="cpu", ctx=ctx)
        own = {n: p.detach().clone() for n, p in model.named_leaves()}
        model.load_reference_params(tree)
        q = model.layers[0].attn.q.w.detach().numpy()
        np.testing.assert_array_equal(
            q, tree["layers"]["attn"]["q_w"][0][:, m * 2 * hd:][:, :2 * hd])
        if m == 3:   # heads 6 and 7: padding, zero in both builds
            assert not q.any() and not own["layers/0/attn/q/w"].any()
            assert not own["layers/0/attn/o/w"].any()
        else:
            assert own["layers/0/attn/q/w"].all()


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

def test_step0_loss_matches_reference_at_the_same_mesh(groups):
    ref = groups["ref"].results()
    got12 = [float(r["grads/0/loss"]) for r in groups[2].results()]
    got22 = [float(r["trainer/1/loss"][0]) for r in groups[4].results()]
    assert len(set(got12)) == 1 and len(set(got22)) == 1
    assert abs(got12[0] - float(ref["loss0/1x2"])) < 1e-6, \
        (got12, ref["loss0/1x2"])
    assert abs(got22[0] - float(ref["t22/loss"][0])) < 1e-6, \
        (got22, ref["t22/loss"])


def test_gradients_1x2_equal_the_1x1_gradient(groups):
    """Every leaf, gathered: within 1e-5 max|g| of the port's 1x1 gradient
    and of the reference's (jax.grad at tp = 1)."""
    inp, params = groups["inp"], groups["params"]
    model = port_model(params)
    b = torch_batch(inp)
    model(b["tokens"], b["labels"]).backward()
    cfg = ref_cfg()
    ref_model = build_model(cfg, ref_make_ctx(cfg, 1, 1))
    jb = {k: jnp.asarray(inp[f"batch/{k}"]) for k in ("tokens", "labels")}
    ref_g = jax.grad(lambda p: ref_model.train_loss(p, jb)[0])(params)
    ranks = groups[2].results()
    for name, path, idx in model.reference_leaves():
        port = dict(model.named_leaves())[name].grad.numpy()
        rg = np.asarray(spec_tree_get(ref_g, path))
        rg = rg[idx] if idx else rg
        for want in (port, rg):
            tol = 1e-5 * float(np.abs(want).max()) + 1e-12
            for r in ranks:
                np.testing.assert_allclose(r[f"grads/0/{name}"], want,
                                           rtol=0, atol=tol, err_msg=name)


def test_grad_norm_is_the_true_one_where_the_reference_doubles(groups):
    """The reference's TP gradient is M times the true one (ROADMAP queue
    3): its ``grad_norm`` at (1, 2) is twice its (1, 1) value.  The port's
    2x2 step-0 ``grad_norm`` is the (1, 1) value."""
    ref = groups["ref"].results()
    g11, g12 = float(ref["grad_norm/1x1"]), float(ref["grad_norm/1x2"])
    assert abs(g12 / g11 - 2.0) < 1e-5, (g11, g12)
    for r in groups[4].results():
        got = float(r["trainer/1/grad_norm"][0])
        assert abs(got / g11 - 1.0) < 1e-5, (got, g11)


def test_sgd_1x2_matches_the_port_1x1(groups):
    inp, params = groups["inp"], groups["params"]
    prog = build_program(port_cfg(), "1x1", TrainerConfig(
        opt=OptConfig(kind="sgd", lr=0.1, grad_clip=0.0)), device="cpu")
    prog.model.load_reference_params(jax.tree.map(np.asarray, params))
    attach_train(prog)
    want = [float(prog.train_step(torch_batch(inp))["loss"])
            for _ in range(2)]
    for r in groups[2].results():
        np.testing.assert_allclose(r["sgd/losses"], want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the 2x2 trainer
# ---------------------------------------------------------------------------

def test_trainer_2x2_matches_reference(groups):
    ref, ranks = groups["ref"].results(), groups[4].results()
    for r, res in enumerate(ranks):
        dev = f"d{r // 2}m{r % 2}"
        np.testing.assert_allclose(res["trainer/1/loss"], ref["t22/loss"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(
            res["trainer/1/rank_words"],
            ref[f"t22/sync/sparse_sent_words/{dev}"])
        np.testing.assert_array_equal(res["trainer/1/rank_overflow"],
                                      ref[f"t22/sync/overflow/{dev}"])
        np.testing.assert_array_equal(
            res["trainer/1/sync/sparse_sent_words"],
            (ref["t22/sync/sparse_sent_words/d0m0"]
             + ref["t22/sync/sparse_sent_words/d0m1"]) / 2)
        assert not res["trainer/1/sync/overflow"].any()
        # ZeRO-1 is bitwise the full update; a process holds 1 / D of its
        # shard's moments (two f32 moments a parameter; every leaf even)
        assert bool(res["trainer/zero1_bitwise"])
        np.testing.assert_array_equal(res["trainer/1/loss"],
                                      res["trainer/0/loss"])
        assert int(res["trainer/0/moment_bytes"]) == \
            8 * int(res["trainer/0/local_numel"])
        assert 2 * int(res["trainer/1/moment_bytes"]) == \
            int(res["trainer/0/moment_bytes"])
    for name, _ in Model(port_cfg(), device="cpu").named_leaves():
        key = f"trainer/1/params/{name}"
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[key], ranks[0][key])


def test_checkpoint_2x2_continues_bitwise(groups):
    for res in groups[4].results():
        a, b = res["ckpt/losses"]
        assert a == b and bool(res["ckpt/params_bitwise"])


# ---------------------------------------------------------------------------
# serving at 1x2
# ---------------------------------------------------------------------------

def port_serve_1x1(params, prompt: np.ndarray) -> np.ndarray:
    """The port's 1x1 greedy tokens from the prompt, as the launcher
    serves (prefill, handoff, decode)."""
    prog = build_program(port_cfg(), "1x1", device="cpu")
    prog.model.load_reference_params(jax.tree.map(np.asarray, params))
    tokens = torch.from_numpy(prompt).long()
    B, S = tokens.shape
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    logits, cache = prog.prefill_step({"tokens": tokens})
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    decode = st.make_decode_step(prog.model, prog.cache_specs["window"])
    cache = serve.handoff(prog, cache)
    tok = logits.float().argmax(-1)[:, None]
    toks = [tok]
    for _ in range(GEN - 1):
        tok, _, cache = decode(cache, tok)
        toks.append(tok)
    return torch.cat(toks, 1).numpy()


def test_serve_1x2_matches_reference_and_1x1(groups):
    ref, ranks = groups["ref"].results(), groups[2].results()
    L = port_cfg().n_layers
    for m, res in enumerate(ranks):
        for i in range(L):
            for k in ("k", "v", "pos"):
                want = ref[f"serve/cache/{k}/d0m{m}"][i]
                got = res[f"serve/cache/{i}/{k}"]
                assert got.shape == want.shape, (k, got.shape, want.shape)
                # 1e-5 of the largest value (CACHE_TOL)
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=CACHE_TOL * float(np.abs(want).max()),
                    err_msg=f"rank {m} layer {i} {k}")
        np.testing.assert_allclose(res["serve/logits"], ref["serve/logits"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(res["serve/tokens"],
                                      ref["serve/tokens/1x1"])
        # the decode cache holds positions m, m + 2, ... of the 23 written
        held = res["serve/pos"]
        assert held[held >= 0].tolist() == list(range(m, PROMPT + GEN - 1, 2))
        # the decode cache whole on every rank (decode_seq_shard off): the
        # prompt's every position, the same tokens
        assert res["serve_whole/pos"][:PROMPT + GEN - 1].tolist() == \
            list(range(PROMPT + GEN - 1))
        np.testing.assert_array_equal(res["serve_whole/tokens"],
                                      ref["serve/tokens/1x1"])
    np.testing.assert_array_equal(
        port_serve_1x1(groups["params"], groups["inp"]["serve/tokens"]),
        ref["serve/tokens/1x1"])


def test_reference_tp_decode_mixes_heads(groups):
    """Records a reference-side fault (ROADMAP queue 3): at (1, 2) with
    the q heads sharded, the reference's ``gqa_decode`` sums the partial
    softmaxes of different heads over the sequence-sharded cache, so its
    greedy tokens part from its own (1, 1) tokens from the first one; the
    port's 1x2 tokens are the (1, 1) ones (the test above)."""
    ref = groups["ref"].results()
    assert (ref["serve/tokens/1x2"][:, 0] != ref["serve/tokens/1x1"][:, 0]
            ).all()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_2x2_under_torchrun(groups):
    cli = groups["cli"]
    assert cli.wait() == [0], cli.log(0)[-3000:]
    log = cli.log(0)
    line = next(ln for ln in log.splitlines()
                if ln.startswith("dist result "))
    res = json.loads(line[len("dist result "):])
    one = train.main([*CLI, "--mesh", "1x1"])
    assert np.isfinite(res["losses"]).all()
    assert abs(res["losses"][0] - one["losses"][0]) < 1e-2, \
        (res["losses"], one["losses"])
    # every rank runs the Zen route once a step (plain versions here)
    for k in ("zen_encode", "zen_commit_push", "zen_commit_pull"):
        assert res["plain_calls"][k] == 4 * 2, res["plain_calls"]
    assert res["overflow"] == 0 and len(res["peak_gib_by_rank"]) == 4
    # rank 0 alone logs
    assert sum(ln.startswith("step ") for ln in log.splitlines()) == 2
