"""The harness of ``tests/test_torch_tp_ssm.py`` and ``test_torch_tp_attn.py``:
tensor parallelism (M = 2) of the SSM, hybrid, MLA, enc_dec and vlm
configs, reduced, in f32, against the reference and the port's own 1x1
run.

:func:`start` starts, for several configs at once, a 2x2 and a 1x2 group
of ``tests/torch_tp_rank.py`` processes (each config's inputs under
``<arch>/`` in one ``inputs.npz``) and one ``tests/torch_tp_reference.py
OUT arch ARCH`` process a config (4 forced host devices); both sides start
from the reference's 1-device init of seed 0.  The ``check_*`` functions
hold one config's results:

* :func:`check_weights`: each model rank's shard after
  ``load_reference_params`` of the reference's (2, 2) init is bitwise that
  init's shard on the devices of that model index; a seed-0 build's shards,
  gathered over the 2x2 ranks (``checkpoint.io.gather_params``), are
  bitwise the port's 1x1 build, and ``io.load_params`` of them into a
  seed-1 build gives back each rank's shards;
* :func:`check_step0_loss`: the step-0 loss at 1x2 and 2x2 within 1e-6 of
  the reference's at the same mesh;
* :func:`check_gradients`: every leaf's 1x2 gradient, gathered, within
  ``GRAD_TOL`` max|g| of the port's 1x1 gradient; the reference's
  ``grad_norm`` at (1, 2) is twice the port's 1x1 norm (ROADMAP queue 3);
* :func:`check_trainer`: 4 AdamW steps with Zen (the reference's hash
  seeds) at 2x2 under ZeRO-1 within 1e-3 of the reference's, each model
  rank's words and overflow bitwise the reference's on its devices, the
  parameters bitwise the full update's; :func:`check_checkpoint`: a 2x2
  checkpoint saved after a step, restored into a fresh trainer, steps on
  bit for bit;
* :func:`check_serve`: at 1x2 each rank's prefill cache within
  ``CACHE_TOL`` of its largest value of the reference's shard on that
  device, the gathered logits within 1e-5 of the reference's, and 8
  greedy tokens (the prefill's argmax, then 7 decode steps from the
  handed-off cache) equal to the port's 1x1 tokens, also with the decode
  cache whole on every rank;
* :func:`reference_tokens`: the reference's (1, 2) and (1, 1) tokens,
  from the same prefill and handoff.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.common import make_ctx as ref_make_ctx
from repro.models.model import build_model
from repro_torch.launch import serve
from repro_torch.models.common import make_ctx
from repro_torch.models.model import Model
from repro_torch.train import steps as st
from repro_torch.train.build import attach_serve, build_program
from test_torch_tp import (BATCH, CACHE_TOL, PROMPT, PROMPT_BATCH, SEQ,
                           RankGroup, Reference, port_cfg, ref_cfg,
                           stub_group, zen_seeds)
from torch_tp_rank import GEN, torch_inputs

# the 1x2 gradient's gate, a share of the leaf's largest value
GRAD_TOL = 1e-5


def arch_inputs(arch: str) -> tuple[dict, dict]:
    """The reference's global params (1 device, seed 0), flattened, the
    batch and the prompt (with their frames or patches); and the params'
    pytree."""
    cfg = ref_cfg(arch)
    params = build_model(cfg, ref_make_ctx(cfg, 1, 1)).init(
        jax.random.PRNGKey(0))[0]
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    batch = next(iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=SEQ,
                                                        batch=BATCH))))
    prompt = next(iter(RefSyntheticLM(cfg, RefDataConfig(
        seq_len=PROMPT, batch=PROMPT_BATCH))))
    inp = {**flat, "arch": arch,
           **{f"batch/{k}": v for k, v in batch.items()},
           **{f"serve/{k}": v for k, v in prompt.items() if k != "labels"}}
    return inp, jax.tree.map(np.asarray, params)


def start(archs: list[str], zen: tuple[str, ...], tmp_path_factory,
          jobs2: tuple[str, ...] = ()) -> dict:
    """Write the inputs of every config in ``archs``, start the 2x2 and
    1x2 groups and a reference process a config; the configs in ``zen``
    run the 2x2 Zen trainer and its checkpoint round trip, the others a
    step-0 loss at 2x2; the 1x2 group runs ``jobs2`` too."""
    inp: dict = {"archs": np.array(archs)}
    out: dict = {"inp": {}, "params": {}, "ref": {}}
    for arch in archs:
        a_inp, out["params"][arch] = arch_inputs(arch)
        if arch in zen:
            a_inp["zen_seeds"] = zen_seeds(arch)
        out["inp"][arch] = a_inp
        inp.update({f"{arch}/{k}": v for k, v in a_inp.items()})
        out["ref"][arch] = Reference(tmp_path_factory.mktemp("ref"), "arch",
                                     arch, *(("zen",) if arch in zen else ()))
    jobs4 = ["weights"] + [job for a in archs for job in (
        (f"{a}:trainer", f"{a}:ckpt") if a in zen else (f"{a}:loss0",))]
    for n, jobs in ((4, jobs4), (2, ["grads", "serve", *jobs2])):
        work = tmp_path_factory.mktemp(f"tp{n}")
        np.savez(work / "inputs.npz", **inp)
        out[n] = RankGroup(work, n, jobs)
    return out


def stop(groups: dict) -> None:
    for procs in (groups[4], groups[2], *groups["ref"].values()):
        procs.kill()


def ranks(groups: dict, n: int, arch: str) -> list[dict]:
    """The ``n``-rank group's results for ``arch``, by rank."""
    pre = f"{arch}/"
    return [{k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
            for res in groups[n].results()]


def port_1x1(groups: dict, arch: str) -> Model:
    """The port's 1x1 model with the reference's parameters."""
    model = Model(port_cfg(arch), device="cpu")
    model.load_reference_params(groups["params"][arch])
    return model


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def check_weights(groups: dict, arch: str) -> None:
    ref = groups["ref"][arch].results()
    tree: dict = {}
    for key in ref:
        if key.startswith("p22/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = ref[key]
    cfg = port_cfg(arch)
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
    for res in ranks(groups, 4, arch):
        for name, p in seed0.named_leaves():
            np.testing.assert_array_equal(res[f"seed0/{name}"],
                                          p.detach().numpy(), name)
        assert bool(res["seed0/load_params_bitwise"])


# ---------------------------------------------------------------------------
# forward, gradients, the 2x2 trainer
# ---------------------------------------------------------------------------

def check_step0_loss(groups: dict, arch: str, zen: bool) -> None:
    ref = groups["ref"][arch].results()
    got12 = [float(r["grads/0/loss"]) for r in ranks(groups, 2, arch)]
    got22 = [float(r["trainer/1/loss"][0] if zen else r["loss0"])
             for r in ranks(groups, 4, arch)]
    assert len(set(got12)) == 1 and len(set(got22)) == 1
    assert abs(got12[0] - float(ref["loss0/1x2"])) < 1e-6, \
        (got12, ref["loss0/1x2"])
    assert abs(got22[0] - float(ref["t22/loss"][0])) < 1e-6, \
        (got22, ref["t22/loss"])


def reference_grads_1x1(groups: dict, arch: str, model: Model) -> dict:
    """The reference's 1x1 gradient (``jax.grad`` of its train loss) on
    the batch, by the port's leaf name."""
    cfg = ref_cfg(arch)
    ref_model = build_model(cfg, ref_make_ctx(cfg, 1, 1))
    jb = {k[len("batch/"):]: jnp.asarray(v)
          for k, v in groups["inp"][arch].items() if k.startswith("batch/")}
    g = jax.grad(lambda p: ref_model.train_loss(p, jb)[0])(
        jax.tree.map(jnp.asarray, groups["params"][arch]))
    out = {}
    for name, path, idx in model.reference_leaves():
        leaf = g
        for k in path:
            leaf = leaf[k]
        out[name] = np.asarray(leaf)[idx] if idx else np.asarray(leaf)
    return out


def check_gradients(groups: dict, arch: str, tol: float = GRAD_TOL,
                    control: bool = False) -> None:
    """The 1x2 gradient against the port's 1x1 one within ``tol`` of each
    leaf's largest value.  With ``control``, the gate rests on the
    reference's 1x1 gradient: it must part from the port's 1x1 gradient
    by more than ``GRAD_TOL`` somewhere (f32 reordering alone moves this
    model's gradient past that gate) and by less than ``tol``."""
    model = port_1x1(groups, arch)
    b = torch_inputs(groups["inp"][arch], "batch/")
    model(**b).backward()
    ref = groups["ref"][arch].results()
    want = {name: p.grad.numpy() for name, p in model.named_leaves()}
    for res in ranks(groups, 2, arch):
        for name, g in want.items():
            # a key bias's gradient is zero but for rounding (a softmax
            # does not see a shift of a query's scores): its gate is a
            # share of its key weight's gradient, as tests/test_torch_whisper
            # gates it
            scale = want[name[:-1] + "w"] if name.endswith("/k/b") else g
            np.testing.assert_allclose(
                res[f"grads/0/{name}"], g, rtol=0,
                atol=tol * float(np.abs(scale).max()) + 1e-12, err_msg=name)
    if control:
        ctrl = reference_grads_1x1(groups, arch, model)
        gap = max(float(np.abs(ctrl[n] - g).max() / np.abs(g).max())
                  for n, g in want.items())
        assert GRAD_TOL < gap < tol, gap
    sq = sum(float((p.grad.double() ** 2).sum()) for _, p in
             model.named_leaves())
    # the reference's TP gradient is M times the true one
    assert abs(float(ref["grad_norm/1x2"]) / np.sqrt(sq) - 2.0) < 1e-4, \
        (float(ref["grad_norm/1x2"]), np.sqrt(sq))


def check_checkpoint(groups: dict, arch: str) -> None:
    """A 2x2 checkpoint (gathered over the model group, the moments over
    the world), restored into a fresh trainer, continues bit for bit."""
    for res in ranks(groups, 4, arch):
        a, b = res["ckpt/losses"]
        assert a == b and bool(res["ckpt/params_bitwise"])


def check_trainer(groups: dict, arch: str) -> None:
    ref, res4 = groups["ref"][arch].results(), ranks(groups, 4, arch)
    for r, res in enumerate(res4):
        dev = f"d{r // 2}m{r % 2}"
        np.testing.assert_allclose(res["trainer/1/loss"], ref["t22/loss"],
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(
            res["trainer/1/rank_words"],
            ref[f"t22/sync/sparse_sent_words/{dev}"])
        np.testing.assert_array_equal(res["trainer/1/rank_overflow"],
                                      ref[f"t22/sync/overflow/{dev}"])
        assert not res["trainer/1/sync/overflow"].any()
        assert bool(res["trainer/zero1_bitwise"])
        np.testing.assert_array_equal(res["trainer/1/loss"],
                                      res["trainer/0/loss"])
        assert 2 * int(res["trainer/1/moment_bytes"]) == \
            int(res["trainer/0/moment_bytes"])
    for name, _ in Model(port_cfg(arch), device="cpu").named_leaves():
        key = f"trainer/1/params/{name}"
        for res in res4[1:]:
            np.testing.assert_array_equal(res[key], res4[0][key])


# ---------------------------------------------------------------------------
# serving at 1x2
# ---------------------------------------------------------------------------

def port_serve_1x1(groups: dict, arch: str) -> tuple:
    """The port's 1x1 greedy tokens from the prompt, as the launcher
    serves (prefill, handoff, decode), and its prefill's last-position
    logits (f32)."""
    prog = build_program(port_cfg(arch), "1x1", device="cpu")
    prog.model.load_reference_params(groups["params"][arch])
    prompt = torch_inputs(groups["inp"][arch], "serve/")
    B, S = prompt["tokens"].shape
    attach_serve(prog, seq_len=S, global_batch=B, mode="prefill")
    logits, cache = prog.prefill_step(prompt)
    attach_serve(prog, seq_len=S + GEN, global_batch=B, mode="decode")
    decode = st.make_decode_step(prog.model, prog.cache_specs["window"])
    cache = serve.handoff(prog, cache)
    tok = logits.float().argmax(-1)[:, None]
    toks = [tok]
    for _ in range(GEN - 1):
        tok, _, cache = decode(cache, tok)
        toks.append(tok)
    return torch.cat(toks, 1).numpy(), logits.float().numpy()


def cache_map(cfg) -> list[dict]:
    """Per layer application in execution order, {the port's cache key:
    (the reference's prefill-cache leaf, its index)}."""
    if cfg.kind == "ssm":
        return [{k: (f"layers/{k}", (i,)) for k in ("state", "conv")}
                for i in range(cfg.n_layers)]
    attn = ("c", "kr", "pos") if cfg.mla_q_rank else ("k", "v", "pos")
    if cfg.kind == "hybrid":
        every = cfg.shared_attn_every
        out = []
        for g in range(cfg.n_layers // every):
            out.append({k: (f"attn/{k}", (g,)) for k in attn})
            out += [{k: (f"ssm/{k}", (g, j)) for k in ("state", "conv")}
                    for j in range(every)]
        return out + [{k: (f"ssm_tail/{k}", (i,)) for k in ("state", "conv")}
                      for i in range(cfg.n_layers % every)]
    out = [{k: (f"layers/{k}", (i,)) for k in attn}
           for i in range(cfg.n_layers)]
    if cfg.kind == "enc_dec":
        for i, entry in enumerate(out):
            entry.update({"cross/k": ("cross", (i, 0)),
                          "cross/v": ("cross", (i, 1))})
    return out


def check_serve(groups: dict, arch: str, logit_tol: float = 1e-5,
                control: bool = False) -> None:
    """The 1x2 server against the reference's at (1, 2) and the port's
    1x1 tokens.  With ``control``, the logits' gate ``logit_tol`` rests
    on the port's 1x1 prefill: its logits must part from the reference's
    (1, 1) logits by more than 1e-5 (f32 reordering alone moves them past
    that gate) and by less than ``logit_tol``."""
    ref = groups["ref"][arch].results()
    cfg = port_cfg(arch)
    want_tokens, logits = port_serve_1x1(groups, arch)
    if control:
        gap = float(np.abs(logits - ref["serve/logits/1x1"]).max())
        assert 1e-5 < gap < logit_tol, gap
    for m, res in enumerate(ranks(groups, 2, arch)):
        for i, entry in enumerate(cache_map(cfg)):
            for k, (leaf, idx) in entry.items():
                want = ref[f"serve/cache/{leaf}/d0m{m}"][idx]
                got = res[f"serve/cache/{i}/{k}"]
                assert got.shape == want.shape, (i, k, got.shape, want.shape)
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=CACHE_TOL * float(np.abs(want).max()),
                    err_msg=f"rank {m} layer {i} {k}")
        np.testing.assert_allclose(res["serve/logits"],
                                   ref["serve/logits/1x2"], rtol=0,
                                   atol=logit_tol)
        np.testing.assert_array_equal(res["serve/tokens"], want_tokens)
        np.testing.assert_array_equal(res["serve_whole/tokens"], want_tokens)
        if "serve/pos" in res:   # positions m, m + 2, ... of those written
            held = res["serve/pos"]
            t = PROMPT + (cfg.n_patches if cfg.kind == "vlm" else 0)
            assert held[held >= 0].tolist() == list(range(m, t + GEN - 1, 2))


def reference_tokens(groups: dict, arch: str) -> tuple:
    ref = groups["ref"][arch].results()
    return ref["serve/tokens/1x2"], ref["serve/tokens/1x1"]
