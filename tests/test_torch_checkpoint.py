"""Checkpointing (``checkpoint/io.py``), mirroring tests/test_system.py's and
tests/test_sparsify.py's round trips, and the launcher's ``--ckpt-dir``.

* f32, bf16 and integer tensors and ints round-trip bit for bit through
  ``arrays.npz`` + ``manifest.json`` (no pickle), keys holding ``/`` too;
  the reference's own checkpoint of the same leaves holds the same bits;
* the reduced qwen2's parameters round-trip, and a trainer restored from a
  checkpoint of its parameters and optimizer state (EF residual included)
  continues bit for bit as the uninterrupted one;
* a compressed GradSync's residual saved after one step, restored and
  continued equals the uninterrupted residual;
* ``launch/train.py --ckpt-dir`` writes ``step_<k>`` and ``final`` with the
  model's parameters; ``--replan-every`` is accepted with an explicit
  ``--sync``, and under ``auto`` runs the density controller: a measured
  density that flips the plan's pick prints the reference's ``replan @
  step`` line and rebuilds the plan, the residuals' keys and shapes
  unchanged.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.checkpoint import io as ref_io
from repro_torch.checkpoint import io
from repro_torch.configs import get_config
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models.model import Model
from repro_torch.train.build import attach_train, build_program
from repro_torch.train.steps import TrainerConfig


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here: the suite runs in parallel
    workers, where torch's default pool oversubscribes the cores and these
    tests' many small ops on ~1M-element tensors slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return {torch.float32: lambda x: x.view(torch.int32),
            torch.bfloat16: lambda x: x.view(torch.int16)}.get(
                t.dtype, lambda x: x)(t)


def _assert_same_tree(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    else:
        assert a == b


def test_roundtrip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"layers/0/attn/q/w": torch.randn(3, 5, generator=g)
                       .to(torch.bfloat16),
                       "ln_f/scale": torch.randn(7, generator=g),
                       "neg0": torch.tensor([-0.0, float("inf")])},
            "counts": {"i32": torch.arange(-4, 4, dtype=torch.int32),
                       "i64": torch.tensor(2**40, dtype=torch.int64)},
            "step": 3}
    io.save(tmp_path / "ck", tree)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["arrays.npz", "manifest.json"]
    back = io.restore(tmp_path / "ck", device="cpu")
    _assert_same_tree(tree, back)
    # the reference's checkpoint of the same leaves holds the same bits
    flat = {"a": back["params"]["layers/0/attn/q/w"],
            "b": back["params"]["ln_f/scale"], "c": back["counts"]["i32"]}
    as_jax = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
              for k, v in flat.items()}
    ref_io.save(tmp_path / "ref", as_jax)
    ref = ref_io.restore(tmp_path / "ref")
    for k, v in flat.items():
        r = np.asarray(ref[k])
        r = r.view(np.int16) if r.dtype == jnp.bfloat16 else r
        np.testing.assert_array_equal(_bits(v).numpy().view(r.dtype), r)


def test_rejects_other_leaves(tmp_path):
    with pytest.raises(TypeError):
        io.save(tmp_path / "x", {"a": [1, 2]})
    with pytest.raises(TypeError):
        io.save(tmp_path / "x", {"a": 1.5})


def _port_cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype=torch.float32)


def test_model_params_roundtrip(tmp_path):
    model = Model(get_config("qwen2-0.5b").reduced(), device="cpu")
    params = dict(model.named_leaves())
    io.save(tmp_path / "ckpt", {"params": params, "step": 3})
    back = io.restore(tmp_path / "ckpt", device="cpu")
    assert back["step"] == 3
    assert list(back["params"]) == list(params)
    for name, p in params.items():
        assert torch.equal(_bits(back["params"][name]), _bits(p.detach()))


def _trainer(compress="topk:0.01"):
    prog = build_program(_port_cfg(), "2x1", TrainerConfig(
        sync=SyncConfig(compress=compress, bucket_bytes=1 << 18)),
        device="cpu")
    attach_train(prog)
    return prog


def _batches(n):
    it = iter(SyntheticLM(_port_cfg(), DataConfig(seq_len=16, batch=4)))
    return [{k: torch.as_tensor(v).long() for k, v in next(it).items()}
            for _ in range(n)]


def _load_state(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict):
            _load_state(dst[k], v)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def test_trainer_restart_continues_bitwise(tmp_path):
    """Params and optimizer state (moments, step, EF residual) saved after
    2 steps and restored into a fresh trainer: steps 3-4 equal the
    uninterrupted run's bit for bit."""
    batches = _batches(4)
    full = _trainer()
    ref = [full.train_step(b) for b in batches]
    part = _trainer()
    for b in batches[:2]:
        part.train_step(b)
    io.save(tmp_path / "ck", {"params": dict(part.model.named_leaves()),
                              "opt": part.opt_state()})
    back = io.restore(tmp_path / "ck", device="cpu")
    assert back["opt"]["step"] == 2 and "residual" in back["opt"]
    fresh = _trainer()
    with torch.no_grad():
        for name, p in fresh.model.named_leaves():
            p.copy_(back["params"][name])
    _load_state(fresh.opt_state(), back["opt"])
    got = [fresh.train_step(b) for b in batches[2:]]
    for a, b in zip(got, ref[2:]):
        for k in ("loss", "grad_norm", "sync/sparse_sent_words"):
            assert torch.equal(a[k], b[k]), k
    for (_, p), (_, q) in zip(fresh.model.named_leaves(),
                              full.model.named_leaves()):
        assert torch.equal(p, q)
    _assert_same_tree(fresh.opt_state(), full.opt_state())


def test_residual_checkpoint_continues_bitwise(tmp_path):
    leaves = [("embed/table", (256, 8), torch.float32)] + [
        (f"layers/w{i}", (256,), torch.float32) for i in range(8)]
    gs = GradSync(SyncConfig(compress="topk:0.05", bucket_bytes=4096),
                  ["embed/table"], leaves, 4)
    rng = np.random.default_rng(0)

    def grads():
        return {nm: torch.from_numpy(np.round(rng.standard_normal(
            (4, *shape)) * 8).astype(np.float32) / 8)
            for nm, shape, _ in leaves}

    _, res1, _ = gs(grads(), gs.init_residual("cpu"), step=0)
    io.save(tmp_path / "ck", {"residual": res1, "step": 1})
    back = io.restore(tmp_path / "ck", device="cpu")
    _assert_same_tree({"residual": res1, "step": 1}, back)
    g2 = grads()
    _, r_a, _ = gs(g2, res1, step=1)
    _, r_b, _ = gs(g2, back["residual"], step=1)
    _assert_same_tree(r_a, r_b)


def test_launcher_ckpt_dir(tmp_path, monkeypatch, capsys):
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--mesh", "2x1",
            "--global-batch", "4", "--seq-len", "16", "--steps", "3",
            "--log-every", "1", "--device", "cpu", "--compress", "topk:0.01",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--replan-every", "2"]
    out = train.main(argv)
    assert len(out["losses"]) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["final", "step_2"]
    final = io.restore(tmp_path / "final", device="cpu")
    assert final["step"] == 3
    assert io.restore(tmp_path / "step_2", device="cpu")["step"] == 2
    init = Model(get_config("qwen2-0.5b").reduced(), device="cpu")
    names = [n for n, _ in init.named_leaves()]
    assert list(final["params"]) == names
    moved = 0
    for name, p in init.named_leaves():
        q = final["params"][name]
        assert q.dtype == p.dtype and q.shape == p.shape
        moved += not torch.equal(q, p.detach())
    assert moved > len(names) // 2    # the run trained them
    # --sync auto --replan-every 2: threshold:0 keeps every element, so
    # the measured density (1.0) flips the controller from the plan's zen
    # (priced at the spec's 0.01 budget) to dense, and the plan is rebuilt
    # with the optimizer state carried over
    seen = []

    def spy(prog, **kw):
        if prog.train_step is None:     # the launcher's first attach
            return attach_train(prog, **kw)
        shapes = {k: tuple(v.shape)
                  for k, v in prog.opt_state()["residual"].items()}
        attach_train(prog, **kw)
        seen.append((shapes, {k: tuple(v.shape) for k, v in
                              prog.opt_state()["residual"].items()},
                     prog.gradsync.bucket_schemes()))

    monkeypatch.setattr(train, "attach_train", spy)
    auto = argv[:-8] + ["--compress", "threshold:0", "--sync", "auto",
                        "--replan-every", "2"]
    out = train.main(auto)
    assert out["replans"] == [2] and len(seen) == 1
    before, after, schemes = seen[0]
    assert before == after and len(before) > 0
    assert set(schemes.values()) == {"dense"}
    assert "replan @ step 2: density drift flips" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 3
