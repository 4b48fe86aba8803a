"""The full ``PxDxM`` mesh of the port (pods and ``--node-size`` beside the
model axis) and its data-parallel server, against the reference and the
port's own runs: reduced qwen2-0.5b and reduced olmoe-1b-7b (``--moe-a2a``)
in f32.

One world of 8 gloo processes (``tests/torch_mesh3_rank.py``) is laid out
anew through new groups as ``2x2x2``, as ``4x2`` on nodes of 2 and as the
flat ``4x2``; the reference runs its (2, 2, 2) and node-split (4, 2)
meshes in a process of its own with 8 forced host devices
(``tests/torch_tp_reference.py mesh3``), from the same 1-device init.

* each rank's shards after ``load_reference_params`` are bitwise the
  reference's shards on that rank's device;
* the step-0 loss is within 1e-6 of the reference's at both layouts;
* 4 AdamW steps with Zen (the reference's hash seeds at every level):
  each rank's ``sync/sparse_sent_words``, ``sync/intra_words``,
  ``sync/inter_words`` and ``sync/overflow`` equal the reference's on
  that device (the row patterns do not depend on the reference's M-fold
  gradient, ROADMAP queue 3), the losses within the 1e-3 that
  ``tests/test_torch_tp.py`` holds the 2x2 Zen losses to;
* each rank's synced step-0 gradient is within 1e-5 of max|g| of the
  port's own flat ``4x2`` run;
* ZeRO-1 is bitwise the full update after 2 steps;
* a ``2x2x2`` checkpoint loads at ``4x2`` with the same parameters;
* the ``2x2`` server (``launch/serve.py``): each rank's prefill logits
  within 1e-6 of the ``1x2`` server's for its sequences, the gathered
  last-position logits within 1e-5 of the reference's (2, 2) prefill, the
  8 greedy tokens of the whole batch the port's ``1x1`` server's (the
  reference's (2, 2) decode mixes heads, ROADMAP queue 3, so decode is
  not compared with it);
* the model axis held in one process still raises, naming item 9, and
  every rank makes the level groups in one world-wide order.

Every spawn waits at most ``TIMEOUT_S``: a group-order deadlock fails the
test instead of hanging the run.
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.common import make_ctx as ref_make_ctx
from repro.models.model import build_model
from repro_torch.configs import get_config
from repro_torch.core.schemes import DistGroup
from repro_torch.core.topology import build_topology
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models.common import make_ctx
from repro_torch.models.model import Model
from repro_torch.train.build import build_program
from test_torch_dist import _env, _free_port, _Procs
from test_torch_tp import ref_cfg, zen_seeds
from torch_mesh3_rank import SERVE_ARGS

HERE = Path(__file__).resolve().parent
RANK_MAIN, REF_MAIN = HERE / "torch_mesh3_rank.py", HERE / "torch_tp_reference.py"
ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")
LAYOUTS = ("2x2x2", "4x2n2")
N, SEQ, BATCH, PROMPT, PROMPT_BATCH = 8, 32, 8, 16, 4


def inputs() -> dict:
    """Every config's reference params (1 device, seed 0), batch, prompt
    and hash seeds, flattened under ``<arch>/``."""
    inp = {"archs": np.array(ARCHS)}
    for arch in ARCHS:
        cfg = ref_cfg(arch)
        params = build_model(cfg, ref_make_ctx(cfg, 1, 1)).init(
            jax.random.PRNGKey(0))[0]
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(k.key) for k in path)
            inp[f"{arch}/params/{key}"] = np.asarray(v)
        batch = next(iter(RefSyntheticLM(cfg, RefDataConfig(
            seq_len=SEQ, batch=BATCH))))
        for k, v in batch.items():
            inp[f"{arch}/batch/{k}"] = v
        inp[f"{arch}/serve/tokens"] = next(iter(RefSyntheticLM(
            cfg, RefDataConfig(seq_len=PROMPT, batch=PROMPT_BATCH))))["tokens"]
        inp[f"{arch}/arch"] = arch
        inp[f"{arch}/zen_seeds"] = zen_seeds(arch)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 ranks and the reference, started at once; the port's 1x1
    server meanwhile."""
    work = tmp_path_factory.mktemp("mesh3")
    np.savez(work / "inputs.npz", **inputs())
    port = str(_free_port())
    ranks = _Procs(work, [
        ([sys.executable, str(RANK_MAIN), str(work)],
         _env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(N),
              LOCAL_WORLD_SIZE=str(N), MASTER_ADDR="127.0.0.1",
              MASTER_PORT=port)) for r in range(N)])
    ref_dir = tmp_path_factory.mktemp("ref3")
    ref = _Procs(ref_dir, [([sys.executable, str(REF_MAIN),
                             str(ref_dir / "ref.npz"), "mesh3", *ARCHS],
                            _env())])
    one = serve.main([a for a in SERVE_ARGS if a not in ("--dist", "gloo")]
                     + ["--mesh", "1x1"])
    out = {"one": one}
    try:
        rcs = ranks.wait()
        if any(rcs):
            pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(
                ranks.log(i)[-3000:] for i in range(N)))
        out["ranks"] = [dict(np.load(work / f"rank{r}.npz"))
                        for r in range(N)]
        if ref.wait()[0]:
            pytest.fail(f"the reference's runs failed:\n"
                        f"{ref.log(0)[-4000:]}")
        out["ref"] = dict(np.load(ref_dir / "ref.npz"))
        yield out
    finally:
        ranks.kill()
        ref.kill()


def port_leaves(arch: str) -> list:
    """(port leaf name, reference path, layer index) of ``arch``'s reduced
    config at M = 2."""
    cfg = get_config(arch).reduced()
    ctx = make_ctx(cfg, 2, 2, moe_a2a=cfg.kind == "moe",
                   group=types.SimpleNamespace(ranks=(0,), n=2, pg=None))
    return Model(cfg, device="cpu", ctx=ctx).reference_leaves()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_the_reference_shards(runs, arch, layout):
    ref = runs["ref"]
    for r, res in enumerate(runs["ranks"]):
        for name, path, idx in port_leaves(arch):
            want = ref[f"{arch}/{layout}/shard/{'/'.join(path)}/r{r}"]
            want = want[idx] if idx else want
            np.testing.assert_array_equal(
                res[f"{arch}/{layout}/shard/{name}"], want,
                f"rank {r} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_matches_reference(runs, arch):
    for layout in LAYOUTS:
        want = float(runs["ref"][f"{arch}/{layout}/loss"][0])
        for res in runs["ranks"]:
            got = float(res[f"{arch}/{layout}/trainer/loss"][0])
            assert abs(got - want) < 1e-6, (layout, got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zen_words_match_reference_device_for_device(runs, arch, layout):
    ref = runs["ref"]
    keys = ["sync/sparse_sent_words", "sync/overflow"]
    if layout == "4x2n2":
        keys += ["sync/intra_words", "sync/inter_words"]
    for r, res in enumerate(runs["ranks"]):
        pre = f"{arch}/{layout}"
        for k in keys:
            np.testing.assert_array_equal(res[f"{pre}/trainer/{k}"],
                                          ref[f"{pre}/{k}/r{r}"],
                                          f"rank {r} {k}")
        assert not res[f"{pre}/trainer/sync/overflow"].any()
        np.testing.assert_allclose(res[f"{pre}/trainer/loss"],
                                   ref[f"{pre}/loss"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_synced_gradient_matches_flat_4x2(runs, arch, layout):
    for r, res in enumerate(runs["ranks"]):
        names = [k[len(f"{arch}/4x2/synced/"):] for k in res
                 if k.startswith(f"{arch}/4x2/synced/")]
        assert names
        for name in names:
            want = res[f"{arch}/4x2/synced/{name}"]
            tol = 1e-5 * float(np.abs(want).max()) + 1e-12
            np.testing.assert_allclose(
                res[f"{arch}/{layout}/synced/{name}"], want, rtol=0,
                atol=tol, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_is_bitwise_the_full_update(runs, arch, layout):
    for res in runs["ranks"]:
        assert bool(res[f"{arch}/{layout}/zero1_bitwise"])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_2x2x2_loads_at_4x2(runs, arch):
    for res in runs["ranks"]:
        assert bool(res[f"{arch}/4x2n2/ckpt_bitwise"])


def test_server_2x2_matches_1x2_reference_and_1x1(runs):
    ranks, ref = runs["ranks"], runs["ref"]
    one = runs["one"]
    b12 = ranks[4]["qwen2-0.5b/serve1x2/logits"]
    for r in range(4):
        pre = "qwen2-0.5b/serve2x2"
        lo, hi = ranks[r][f"{pre}/rows"]
        assert (lo, hi) == ((r // 2) * 2, (r // 2) * 2 + 2)
        # this rank's sequences, against the 1x2 server's
        np.testing.assert_allclose(ranks[r][f"{pre}/logits"][lo:hi],
                                   b12[lo:hi], rtol=0, atol=1e-6)
        # the whole batch's tokens, gathered in its order
        np.testing.assert_array_equal(ranks[r][f"{pre}/tokens"],
                                      one["tokens"])
        np.testing.assert_allclose(
            ranks[r]["qwen2-0.5b/ref_params_logits"],
            ref["qwen2-0.5b/serve22/logits"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ranks[4]["qwen2-0.5b/serve1x2/tokens"],
                                  one["tokens"])
    assert one["tokens"].shape == (PROMPT_BATCH, 8)


def test_model_axis_in_one_process_raises():
    qwen = get_config("qwen2-0.5b").reduced()
    for mesh, node_size in (("2x2x2", 1), ("4x2", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, "
                           "item 9"):
            build_program(qwen, mesh, device="cpu", node_size=node_size)


def test_level_keys_are_gradsyncs_levels():
    """The level groups the mesh makes for each model index are the ones
    GradSync splits its data group into: none for the flat world without
    pods, the pod columns and the pods' data rows at 2x2x2, the cross-node
    columns and the nodes at 4x2 on nodes of 2."""
    def keys(dp, pods=1, node_size=1):
        return tmesh.level_keys(build_topology(dp, node_size), pods)

    assert keys(4) == []
    assert keys(2, pods=2) == [((2, 2), 0), ((2, 2), 1)]
    assert keys(4, node_size=2) == [((1, 2, 2), 1), ((1, 2, 2), 2)]
    assert keys(4, pods=2, node_size=2) == [
        ((2, 2, 2), 0), ((2, 2, 2), 1), ((2, 2, 2), 2)]


def test_data_group_never_makes_level_groups_itself():
    """A data group under a model axis (a sub-group) refuses to make a
    level group it was not handed: on one data group's ranks alone
    ``new_group`` would deadlock the rest of the world."""
    group = DistGroup.__new__(DistGroup)
    group.pg, group.n, group.ranks, group._levels = object(), 4, (0,), {}
    with pytest.raises(RuntimeError, match="mesh_groups"):
        group.split((2, 2), 1)
    mine = types.SimpleNamespace(n=2)
    group.adopt_level((2, 2), 1, mine)
    assert group.split((2, 2), 1) == [([0], mine)]
    with pytest.raises(ValueError, match="do not cover"):
        group.adopt_level((2, 4), 1, mine)


def test_dataparallel_server_refuses_an_uneven_batch():
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--reduced", "--batch",
                             "3", "--device", "cpu", "--mesh", "2x1",
                             "--dist", "gloo"])
    group = types.SimpleNamespace(n=2, ranks=(0,))
    with pytest.raises(ValueError, match="does not split"):
        serve.serve(args, group, None, "cpu")
    with pytest.raises(SystemExit):
        serve.parse_args(["--mesh", "2x1", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_train_launcher_cuts_depth(arch):
    """``launch/train.py --layers N`` trains the first N layers (an
    encoder-decoder's encoder too), as ``launch/serve.py --layers`` serves
    them."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
            "--seq-len", "16", "--global-batch", "2", "--log-every", "1"]
    cfg = get_config(arch).reduced()
    cut = dataclasses.replace(cfg, n_layers=1,
                              n_enc_layers=min(cfg.n_enc_layers, 1))
    assert cfg.n_layers > 1
    for c, extra in ((cfg, []), (cut, ["--layers", "1"])):
        res = train.main([*argv, *extra])
        leaves = len(Model(c, device="cpu").named_leaves())
        assert sum(b["leaves"] for b in res["buckets"]) == leaves
        assert np.isfinite(res["losses"]).all()
