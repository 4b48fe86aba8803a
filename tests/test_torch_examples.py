"""The port's four examples (``examples/torch_*.py``) on the CPU, each
held to what its reference example shows.

* quickstart: Zen equals the dense allreduce, EF top-k sends under 10 % of
  the ring's words, and on the reference's numpy-seeded full-skew array
  the balanced and agsparse words per worker equal the reference's
  ``schemes.simulate`` on the same array;
* train_e2e (2 layers, 3 steps, a 4096-token vocabulary): the loss falls
  and the checkpoint restores bitwise;
* serve_batched (2 layers, 3 tokens): the tokens ``launch/serve.py``
  serves for the same prompt;
* analyze_sparsity: the embedding-gradient row masks are the token sets of
  the reference's ``SyntheticLM`` batches, and the port's metrics on them
  the reference's.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as rmetrics
from repro.core import schemes as RS
from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro_torch.launch import serve

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def few_threads():
    """Small ops: more threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_quickstart_words_equal_the_reference(few_threads):
    res = _example("torch_quickstart").main(["--device", "cpu"])
    assert res["zen_err"] < 1e-5
    assert res["zen_words"] < res["dense_words"]
    assert set(res["ef_schemes"].values()) == {"zen"}
    skewed = jnp.asarray(res["skewed"])
    n = skewed.shape[0]
    _, bal = jax.jit(functools.partial(
        RS.simulate, RS.balanced_sync, n=n, cap_push=res["bal_cap"],
        cap_pull=res["bal_cap"]))(skewed)
    _, ags = jax.jit(functools.partial(
        RS.simulate, RS.agsparse_sync, capacity=res["nnz_total"]))(skewed)
    np.testing.assert_array_equal(res["bal_words"],
                                  np.asarray(bal.sent_words))
    np.testing.assert_array_equal(res["ags_words"],
                                  np.asarray(ags.sent_words))


def test_train_e2e_loss_falls_and_checkpoint_restores(tmp_path, few_threads):
    res = _example("torch_train_e2e").main([
        "--device", "cpu", "--steps", "3", "--layers", "2", "--batch", "2",
        "--seq-len", "32", "--vocab", "4096", "--ckpt",
        str(tmp_path / "ckpt")])
    assert len(res["losses"]) == 3 and res["losses"][-1] < res["losses"][0]
    assert res["restored_bitwise"]


def test_serve_batched_tokens_equal_launch_serve(few_threads):
    got = _example("torch_serve_batched").main(
        ["--device", "cpu", "--layers", "2", "--gen", "3"])
    want = serve.main(["--device", "cpu", "--reduced", "--layers", "2",
                       "--gen", "3", "--batch", "4", "--prompt-len", "32"])
    np.testing.assert_array_equal(got["prompt"], want["prompt"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (4, 3)


def test_analyze_sparsity_masks_are_the_reference_batches(few_threads):
    res = _example("torch_analyze_sparsity").main(["--device", "cpu"])
    cfg = ref_config("qwen2-0.5b").reduced()
    cfg = type(cfg)(**{**cfg.__dict__, "vocab": 4096})
    data = iter(RefSyntheticLM(cfg, RefDataConfig(seq_len=64, batch=2)))
    want = np.zeros((8, 4096), bool)
    for w in range(8):
        want[w, next(data)["tokens"].reshape(-1)] = True
    np.testing.assert_array_equal(res["masks"].numpy(), want)
    masks = jnp.asarray(want)
    for key, got in (
            ("density", rmetrics.density(masks[0])),
            ("overlap", rmetrics.overlap_ratio(masks[0], masks[1])),
            ("densification", rmetrics.densification_ratio(masks)),
            ("skewness", rmetrics.skewness_ratio(masks[0], 16))):
        assert res[key] == pytest.approx(float(got), rel=1e-6), key
