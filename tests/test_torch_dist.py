"""Port parity over a real ``torch.distributed`` group: one process per
rank, gloo on the CPU (``launch/mesh.py``, ``core/schemes.DistGroup``).

The ranks are processes of ``tests/torch_dist_rank.py`` (torch and
``repro_torch`` only) with torchrun's environment, on a free port; they
read their inputs from an ``.npz`` this process writes and write their
outputs back the same way.  The JAX reference runs here, while they run.

* ``zen_sync`` on 4 ranks: each rank's output, wire words and overflow are
  bitwise worker w of the reference's ``simulate(zen_sync,
  backend="xla")``, on all four (fused, fused_commit) routes and the COO
  pull, in f32 and bf16, element- and row-sparse, and at an undersized
  layout that overflows; each rank calls each route's kernel wrappers
  once (plain versions on the CPU);
* the baseline schemes (agsparse, sparcml over ``ppermute``, sparse_ps,
  omnireduce, balanced) on 4 ranks: each rank's output, wire words and
  overflow bitwise worker w of the reference's ``simulate``, f32
  element-sparse dyadic and bf16 row-sparse random values, with small
  capacities that overflow, the aggregation on the scatter-add's plain
  version;
* ``dense_sync`` and a whole ``GradSync`` over the reduced qwen2 gradient
  leaves, one bucket per leaf and with the dense leaves fused into 1 MiB
  buckets: bitwise the reference's psum at 2 ranks; within the summation
  bound ``(n - 1) u sum_w |x_w|`` of the exact sum at 4 (gloo adds in its
  own order); the Zen bucket bitwise at both; the metrics the reference
  GradSync's at the same bucket size; with ``--compress topk:0.01`` (zen
  on every dense bucket) over two steps, each of 2 ranks' synced leaves,
  EF residual and metrics bitwise row w of the in-process ``SimGroup(2)``;
* the reduced f32 qwen2 trainer with the reference's parameters: at 4x1
  within 1e-3 of the reference's (1,1) run with no overflow, each rank
  calling the fused route's wrappers once a step; at 2x1 the in-process
  ``SimGroup`` 2x1 trainer's losses and parameters bit for bit; under
  ZeRO-1 (the ``zero1`` job, 2 ranks) each process holds only its own
  ``[1, c]`` row of every leaf's moments, half the in-process run's
  ``[2, c]`` bytes, and the losses, words and parameters equal the
  in-process ZeRO-1 run's and the full update's bit for bit;
* on a two-level topology (nodes of 2 ranks, every level's group of 2
  ranks) at 4 ranks: GradSync per leaf and bucketed, each rank's synced
  leaves and metrics (``sync/intra_words``, ``sync/inter_words``) bitwise
  row w of the in-process ``SimGroup`` run, and the 4x1 ``--node-size 2``
  trainer's losses, words and parameters bitwise the in-process
  two-level trainer's;
* zenlint's trace sweep (``repro_torch.analysis.lint``) on the 4 ranks'
  ``DistGroup``: no finding, and each rank's recorded bytes per case and
  (collective kind, group size) those of the in-process ``SimGroup(4)``
  sweep of the same cases;
* the launcher under ``torchrun --nproc-per-node 2 ... --dist gloo``
  prints the in-process 2x1 run's losses, and its misuses raise.
"""
import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import schemes as S
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.common import make_ctx
from repro.models.model import build_model
from repro_torch.configs import get_config
from repro_torch.core.topology import build_topology
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.kernels import ops as tops
from repro_torch.launch import train
from repro_torch.launch.mesh import TORCHRUN_ENV, make_data_group
from repro_torch.models.model import Model
from test_torch_trainer import BATCH, SEQ, STEPS, _ref_cfg, _ref_losses
from test_torch_zen_sync import _integer_workers
from torch_dist_rank import COMPRESS, HIER_NODE, VARIANTS

ROOT = Path(__file__).resolve().parents[1]
RANK_MAIN = Path(__file__).resolve().parent / "torch_dist_rank.py"
TIMEOUT_S = 240
MLEN, D = 1 << 11, 8
BUCKET_BYTES = 1 << 20
LINT_M = 1024    # zenlint's payload length in the 4-rank ``lint`` job
JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"f32": torch.float32, "bf16": torch.bfloat16}
U = {"f32": 2.0 ** -24, "bf16": 2.0 ** -8}      # unit roundoff
# case -> (seed, density, dtype, row width or None, layout kwargs)
ZEN_CASES = {
    "f32-element": (2, 0.1, "f32", None, {}),
    "f32-row": (2, 0.1, "f32", D, {}),
    "bf16-element": (2, 0.1, "bf16", None, {}),
    "bf16-row": (2, 0.1, "bf16", D, {}),
    "f32-overflow": (4, 0.2, "f32", None,
                     {"density_budget": 0.05, "r1_factor": 0.5}),
}
CLI = ["--arch", "qwen2-0.5b", "--reduced", "--mesh", "2x1", "--device",
       "cpu", "--steps", "2", "--seq-len", "32", "--global-batch", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    return {**env, "OMP_NUM_THREADS": "1", **extra}


class _Procs:
    """Processes started together, waited for once, all killed on a
    timeout; their output goes to files in ``work``."""

    def __init__(self, work: Path, cmds: list[tuple[list[str], dict]]):
        self.work, self.procs, self.done = work, [], None
        for i, (cmd, env) in enumerate(cmds):
            with open(work / f"log{i}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True))

    def log(self, i: int) -> str:
        return (self.work / f"log{i}.txt").read_text()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self) -> list[int]:
        if self.done is None:
            try:
                self.done = [p.wait(timeout=TIMEOUT_S) for p in self.procs]
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"ranks did not finish in {TIMEOUT_S} s:\n"
                            + "\n".join(self.log(i)[-2000:]
                                        for i in range(len(self.procs))))
        return self.done


class _Group(_Procs):
    """``n`` ranks of ``torch_dist_rank.py`` on ``work/inputs.npz``."""

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


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds), then every process group started at once
# ---------------------------------------------------------------------------

# case -> (scheme, seed, dtype, row width or None, dyadic values)
SCHEME_CASES = {f"{name}-{kind}": (name, 6, dt, d, dy)
                for name in ("agsparse", "sparcml", "sparse_ps", "omnireduce",
                             "balanced")
                for kind, dt, d, dy in (("f32-element", "f32", None, True),
                                        ("bf16-row", "bf16", D, False))}
SCHEME_M = 512


def _scheme_kwargs(name: str, n: int) -> dict:
    from test_torch_schemes import _kwargs
    return _kwargs(name, n)


def _scheme_inputs(n: int) -> dict:
    """npz entries of SCHEME_CASES: values, dtype, scheme and kwargs."""
    from test_torch_schemes import _workers
    inp = {}
    for case, (name, seed, dt, d, dy) in SCHEME_CASES.items():
        v, _ = _workers(seed, n, SCHEME_M, 0.1, dt, d, dy)
        inp.update({f"schemes/{case}/vals": np.asarray(v.astype(jnp.float32)),
                    f"schemes/{case}/dtype": dt,
                    f"schemes/{case}/name": name,
                    **{f"schemes/{case}/kw/{k}": val for k, val in
                       _scheme_kwargs(name, n).items()}})
    return inp


def _zen_inputs(n: int) -> tuple[dict, dict]:
    """npz entries of ZEN_CASES and the reference layouts."""
    inp, layouts = {}, {}
    for case, (seed, density, dt, d, kw) in ZEN_CASES.items():
        kw = {"density_budget": 1.0, "r1_factor": 2.0, **kw}
        vals = _integer_workers(seed, n, MLEN, density, JD[dt], d)
        layouts[case] = lo = S.make_zen_layout(MLEN, n, **kw)
        inp.update({f"zen/{case}/vals": np.asarray(vals.astype(jnp.float32)),
                    f"zen/{case}/dtype": dt, f"zen/{case}/seeds": lo.seeds,
                    **{f"zen/{case}/{k}": v for k, v in kw.items()}})
    return inp, layouts


@functools.cache
def _port_leaves() -> list[tuple[str, tuple]]:
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    return [(nm, tuple(p.shape))
            for nm, p in Model(cfg, device="cpu").named_leaves()]


def _grad_inputs(n: int, seed: int) -> dict:
    """Per-rank gradients of the reduced qwen2 leaves: integer-valued rows
    of the row-sparse embedding (its Zen sums are then exact), random
    normal f32 elsewhere; and two dense_sync stacks (the bf16 one holds
    bf16 values)."""
    rng = np.random.default_rng(seed)
    inp = {"gs_names": np.array([nm for nm, _ in _port_leaves()])}
    for nm, shape in _port_leaves():
        if nm == "embed/table":
            g = np.array(_integer_workers(3, n, shape[0], 0.05, jnp.float32,
                                          shape[1]))
        else:
            g = rng.standard_normal((n, *shape)).astype(np.float32)
        inp[f"gs/{nm}"] = g
    x = rng.standard_normal((n, 300, 7)).astype(np.float32)
    inp["dense/f32"] = x
    inp["dense/bf16"] = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                   .astype(jnp.float32))
    return inp


def _ref_gradsync(inp: dict, n: int, bucket_bytes: int | None = None):
    """The reference GradSync (vmap over n workers) on the same leaves,
    nested by their '/'-joined names."""
    def nest(get):
        tree: dict = {}
        for nm in inp["gs_names"]:
            *path, leaf = str(nm).split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = get(str(nm))
        return tree

    shapes = nest(lambda nm: jax.ShapeDtypeStruct(inp[f"gs/{nm}"].shape[1:],
                                                  jnp.float32))
    gs = RefGradSync(RefSyncConfig(bucket_bytes=bucket_bytes),
                     ["embed/table"], shapes, n)
    return gs, nest(lambda nm: jnp.asarray(inp[f"gs/{nm}"]))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Start the 4-rank and 2-rank groups and the torchrun CLI runs; stop
    whatever still runs at the module's end."""
    ref_params = build_model(_ref_cfg(), make_ctx(_ref_cfg(), 1, 1)).init(
        jax.random.PRNGKey(0))[0]
    batch = next(iter(RefSyntheticLM(_ref_cfg(),
                                     RefDataConfig(seq_len=SEQ, batch=BATCH))))
    flat = {"params/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    common = {**flat, **{f"batch/{k}": v for k, v in batch.items()}}
    out = {"ref_params": ref_params, "batch": batch}
    for n, jobs in ((4, ["zen", "schemes", "dense", "gradsync",
                         "broadcast", "trainer", "hier", "lint"]),
                    (2, ["dense", "gradsync", "compress", "trainer",
                         "zero1"])):
        work = tmp_path_factory.mktemp(f"ranks{n}")
        inp = {**common, **_grad_inputs(n, seed=n), "n": n,
               "gs_bucket_bytes": BUCKET_BYTES, "lint_m": LINT_M}
        if "zen" in jobs:
            zinp, out["layouts"] = _zen_inputs(n)
            inp.update(zinp)
        if "schemes" in jobs:
            inp.update(_scheme_inputs(n))
        gs, tree = _ref_gradsync(inp, n)
        inp["gs_seeds"] = gs._layouts["embed/table", 0].seeds
        np.savez(work / "inputs.npz", **inp)
        out[n] = {"ranks": _Group(work, n, jobs), "inp": inp,
                  "ref_gs": (gs, tree)}
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
    out["cli"] = _Procs(tmp_path_factory.mktemp("cli"), [
        ([*torchrun, *CLI, "--dist", "gloo"], _env()),
        ([*torchrun, *CLI, "--dist", "gloo", "--mesh", "4x1"], _env())])
    yield out
    for procs in (out[4]["ranks"], out[2]["ranks"], out["cli"]):
        procs.kill()


# ---------------------------------------------------------------------------
# zen_sync
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zen_refs(groups):
    """The reference's simulate of each case, bitmap and COO pull (jitted:
    integer-valued sums are exact in any order)."""
    refs = {}
    for case, lo in groups["layouts"].items():
        vals = jnp.asarray(groups[4]["inp"][f"zen/{case}/vals"]).astype(
            JD[ZEN_CASES[case][2]])
        for hb in (True, False):
            refs[case, hb] = jax.jit(functools.partial(
                S.simulate, S.zen_sync, layout=lo, backend="xla",
                use_hash_bitmap=hb))(vals)
    return refs


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(ZEN_CASES))
def test_zen_sync_4_ranks_bitwise_vs_reference(groups, zen_refs, case,
                                               variant):
    ranks = groups[4]["ranks"].results()
    fe, fc, hb = VARIANTS[variant]
    ref_out, ref_st = zen_refs[case, hb]
    if case == "f32-overflow":
        assert int(np.asarray(ref_st.overflow).sum()) > 0
    want_plain = [tops.path_launches(1, fe, fc, hb).get(k, 0)
                  for k in tops.KERNELS]
    for w, r in enumerate(ranks):
        key = f"zen/{case}/{variant}"
        assert r[f"{key}/dtype"] == str(TD[ZEN_CASES[case][2]])
        assert r[f"{key}/out"].shape == (1, *ref_out.shape[1:])
        np.testing.assert_array_equal(
            r[f"{key}/out"][0], np.asarray(ref_out[w].astype(jnp.float32)),
            err_msg=f"rank {w}")
        np.testing.assert_array_equal(r[f"{key}/sent"],
                                      np.asarray(ref_st.sent_words)[w:w + 1])
        np.testing.assert_array_equal(r[f"{key}/overflow"],
                                      np.asarray(ref_st.overflow)[w:w + 1])
        # each wrapper once per rank (the plain versions on the CPU)
        assert r[f"{key}/plain"].tolist() == want_plain


@pytest.mark.parametrize("case", list(SCHEME_CASES))
def test_schemes_4_ranks_bitwise_vs_reference(groups, case):
    ranks = groups[4]["ranks"].results()
    name, _, dt, _, _ = SCHEME_CASES[case]
    vals = jnp.asarray(groups[4]["inp"][f"schemes/{case}/vals"]).astype(JD[dt])
    ref_out, ref_st = jax.jit(functools.partial(
        S.simulate, getattr(S, f"{name}_sync"),
        **_scheme_kwargs(name, 4)))(vals)
    for w, r in enumerate(ranks):
        key = f"schemes/{case}"
        np.testing.assert_array_equal(
            r[f"{key}/out"][0], np.asarray(ref_out[w].astype(jnp.float32)),
            err_msg=f"rank {w}")
        np.testing.assert_array_equal(r[f"{key}/sent"],
                                      np.asarray(ref_st.sent_words)[w:w + 1])
        np.testing.assert_array_equal(r[f"{key}/overflow"],
                                      np.asarray(ref_st.overflow)[w:w + 1])
        assert int(r[f"{key}/plain"]) > 0   # the plain scatter-add, counted


# ---------------------------------------------------------------------------
# dense_sync and GradSync
# ---------------------------------------------------------------------------

def _assert_within_sum_bound(got, stack, u, what, div=1):
    """|got - sum/div| <= (n - 1) u sum|x| / div elementwise for a stack of
    n workers: a sum taken in any order of n - 1 rounded adds (``div``, a
    power of two, divides exactly)."""
    n = stack.shape[0]
    exact = stack.astype(np.float64).sum(0) / div
    bound = (n - 1) * u * np.abs(stack.astype(np.float64)).sum(0) / div
    err = np.abs(got.astype(np.float64) - exact)
    assert (err <= bound).all(), (what, float((err - bound).max()))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_sync_vs_reference_psum(groups, n, dtype):
    """Bitwise the reference's psum at 2 ranks (one commutative add per
    element); within the summation bound at 4."""
    stack = groups[n]["inp"][f"dense/{dtype}"]
    ref_out, ref_st = S.simulate(S.dense_sync,
                                 jnp.asarray(stack).astype(JD[dtype]))
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    for w, r in enumerate(groups[n]["ranks"].results()):
        got = r[f"dense/{dtype}/out"][0]
        np.testing.assert_array_equal(r[f"dense/{dtype}/sent"],
                                      np.asarray(ref_st.sent_words)[w:w + 1])
        if n == 2:
            np.testing.assert_array_equal(got, ref_out[w], err_msg=f"rank {w}")
        else:
            _assert_within_sum_bound(got, stack, U[dtype], f"rank {w}")


def _check_gradsync(g: dict, n: int, key: str, ref_out, ref_st,
                    stat_keys) -> None:
    """Every rank's GradSync outputs ``<key>/<leaf>`` against the
    reference's: the Zen bucket bitwise, the psum leaves bitwise at 2
    ranks and within the summation bound at 4; the metrics bitwise."""
    ranks = g["ranks"].results()
    for nm in g["inp"]["gs_names"]:
        nm = str(nm)
        ref = ref_out
        for p in nm.split("/"):
            ref = ref[p]
        ref = np.asarray(ref)
        stack = g["inp"][f"gs/{nm}"]
        for w, r in enumerate(ranks):
            got = r[f"{key}/{nm}"]
            assert got.shape == (1, *stack.shape[1:]), nm
            if n == 2 or nm == "embed/table":
                np.testing.assert_array_equal(got[0], ref[w],
                                              err_msg=f"{nm} rank {w}")
            else:
                _assert_within_sum_bound(got[0], stack, U["f32"],
                                         f"{nm} rank {w}", div=n)
    for k in stat_keys:
        for w, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"{key}_stats/{k}"],
                                          np.asarray(ref_st[k])[w:w + 1],
                                          err_msg=f"{k} rank {w}")


@pytest.mark.parametrize("n", [2, 4])
def test_gradsync_reduced_qwen2_leaves_vs_reference(groups, n):
    """A whole GradSync (Zen on embed/table, psum elsewhere, mean over n)
    on every rank: the Zen bucket and the sync metrics bitwise the
    reference's at both sizes; the psum leaves bitwise at 2 ranks and
    within the summation bound at 4."""
    g = groups[n]
    gs, tree = g["ref_gs"]
    ref_out, ref_st = jax.jit(jax.vmap(gs, axis_name="data"))(tree)
    _check_gradsync(g, n, "gs", ref_out, ref_st,
                    ("sync/sparse_sent_words", "sync/overflow",
                     "sync/dense_words", "sync/n_buckets"))


@pytest.mark.parametrize("n", [2, 4])
def test_gradsync_bucketed_reduced_qwen2_leaves_vs_reference(groups, n):
    """The same GradSync with the dense leaves fused into BUCKET_BYTES
    buckets: the values held as above (the reference's do not move with
    buckets), every metric bitwise the reference GradSync's at that
    bucket size."""
    g = groups[n]
    gs, tree = g["ref_gs"]
    ref_out = jax.jit(jax.vmap(gs, axis_name="data"))(tree)[0]
    bgs, _ = _ref_gradsync(g["inp"], n, BUCKET_BYTES)
    ref_st = jax.jit(jax.vmap(bgs, axis_name="data"))(tree)[1]
    assert float(ref_st["sync/n_buckets"][0]) < len(g["inp"]["gs_names"])
    _check_gradsync(g, n, "gsb", ref_out, ref_st, list(ref_st))


def test_compressed_gradsync_2_ranks_equal_simgroup(groups):
    """The bucketed GradSync with ``topk:0.01`` (zen on every dense
    bucket's EF-sparsified payload), two steps with the residual threaded
    through: each gloo rank's synced leaves, residuals and metrics equal
    row w of the in-process ``SimGroup(2)`` run bit for bit."""
    g = groups[2]
    inp, ranks = g["inp"], g["ranks"].results()
    names = [str(x) for x in inp["gs_names"]]
    stacks = {nm: torch.from_numpy(inp[f"gs/{nm}"]) for nm in names}
    gs = GradSync(SyncConfig(compress=COMPRESS,
                             bucket_bytes=int(inp["gs_bucket_bytes"])),
                  ["embed/table"], [(nm, tuple(v.shape[1:]), v.dtype)
                                    for nm, v in stacks.items()], 2)
    assert len(gs.compressed_buckets()) > 1
    res = gs.init_residual("cpu")
    for step in range(2):
        synced, res, stats = gs({nm: v * (1 + step)
                                 for nm, v in stacks.items()}, res, step=step)
        for w, r in enumerate(ranks):
            for nm in names:
                np.testing.assert_array_equal(
                    r[f"cgs/{step}/{nm}"][0], synced[nm][w].numpy(),
                    err_msg=f"step {step} {nm} rank {w}")
            for k, v in res.items():
                np.testing.assert_array_equal(
                    r[f"cgs/{step}/res/{k}"][0], v[w].numpy(),
                    err_msg=f"step {step} residual {k} rank {w}")
            for k, v in stats.items():
                np.testing.assert_array_equal(
                    r[f"cgs/{step}/stats/{k}"], v[w:w + 1].float().numpy(),
                    err_msg=f"step {step} {k} rank {w}")
    assert float(stats["sync/overflow"].sum()) == 0


# ---------------------------------------------------------------------------
# the trainer, one process per rank
# ---------------------------------------------------------------------------

def test_build_program_gives_every_rank_rank0_parameters(groups):
    """Rank w initialises from seed w; after build_program's broadcast
    every rank holds the seed-0 model's parameters, bit for bit."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype=torch.float32)
    want = torch.cat([p.detach().reshape(-1) for p in
                      Model(cfg, device="cpu", seed=0).parameters()]).numpy()
    other = torch.cat([p.detach().reshape(-1) for p in
                       Model(cfg, device="cpu", seed=1).parameters()])
    assert not np.array_equal(other.numpy(), want)
    for w, r in enumerate(groups[4]["ranks"].results()):
        np.testing.assert_array_equal(r["broadcast"], want,
                                      err_msg=f"rank {w}")


def test_trainer_4x1_processes_match_reference_1x1(groups):
    ranks = groups[4]["ranks"].results()
    ref = _ref_losses(groups["ref_params"], groups["batch"])
    L = _ref_cfg().n_layers
    want_plain = [STEPS * (tops.path_launches(1).get(k, 0)
                           + 2 * L * (k == "flash_fwd"))
                  for k in tops.KERNELS]
    for w, r in enumerate(ranks):
        losses = r["trainer/loss"]
        assert np.isfinite(losses).all(), losses
        assert np.max(np.abs(losses - np.array(ref))) < 1e-3, (losses, ref)
        assert losses[-1] < losses[0]
        assert r["trainer/sync/overflow"].tolist() == [0.0] * STEPS
        assert r["trainer/sync/sparse_sent_words"].min() > 0
        # every rank returns the same metrics (means over the group)
        for k in ("loss", "sync/overflow", "sync/sparse_sent_words"):
            np.testing.assert_array_equal(r[f"trainer/{k}"],
                                          ranks[0][f"trainer/{k}"])
        # this rank encodes, serves and decodes once a step, and runs each
        # layer's attention twice (its forward and its recompute)
        assert r["trainer/plain"].tolist() == want_plain, w
        assert not r["trainer/launches"].any()
        # the replicated parameters stay the same bits on every rank
        np.testing.assert_array_equal(r["trainer/embed"],
                                      ranks[0]["trainer/embed"])


def test_trainer_2x1_processes_equal_in_process_2x1(groups):
    ranks = groups[2]["ranks"].results()
    sim = ranks[0]
    L = _ref_cfg().n_layers
    assert sim["simgroup/plain"].tolist() == [
        2 * STEPS * (tops.path_launches(1).get(k, 0)
                     + 2 * L * (k == "flash_fwd")) for k in tops.KERNELS]
    for w, r in enumerate(ranks):
        for k in ("loss", "sync/overflow", "sync/sparse_sent_words", "embed"):
            np.testing.assert_array_equal(r[f"trainer/{k}"],
                                          sim[f"simgroup/{k}"],
                                          err_msg=f"{k} rank {w}")


def test_zero1_trainer_2_ranks_equal_in_process_zero1(groups):
    ranks = groups[2]["ranks"].results()
    sim = ranks[0]
    assert sim["zsim/moment_rows"].tolist() == [2]
    # the full update's moments: two f32 tensors the size of the parameters
    full_bytes = 2 * 4 * sim["trainer/params"].size
    assert full_bytes <= sim["zsim/moment_bytes"] < full_bytes * 1.01
    for w, r in enumerate(ranks):
        assert r["zero1/moment_rows"].tolist() == [1]
        assert 2 * r["zero1/moment_bytes"] == sim["zsim/moment_bytes"]
        for k in ("loss", "sync/overflow", "sync/sparse_sent_words",
                  "params"):
            np.testing.assert_array_equal(r[f"zero1/{k}"], sim[f"zsim/{k}"],
                                          err_msg=f"{k} rank {w}")
        np.testing.assert_array_equal(r["zero1/params"], r["trainer/params"],
                                      err_msg=f"full update, rank {w}")
    assert np.isfinite(sim["zsim/loss"]).all()
    assert sim["zsim/sync/overflow"].tolist() == [0.0] * STEPS


@pytest.mark.parametrize("key", ["hgs", "hgsb"])
def test_two_level_4_ranks_equal_in_process(groups, key):
    """Nodes of 2 ranks over gloo: GradSync (per leaf, ``hgs``; bucketed,
    ``hgsb``) and the 4x1 ``--node-size 2`` trainer equal the in-process
    two-level runs bit for bit (each level's group adds two ranks)."""
    g = groups[4]
    inp, ranks = g["inp"], g["ranks"].results()
    names = [str(x) for x in inp["gs_names"]]
    stacks = {nm: torch.from_numpy(inp[f"gs/{nm}"]) for nm in names}
    gs = GradSync(SyncConfig(bucket_bytes=None if key == "hgs"
                             else int(inp["gs_bucket_bytes"])),
                  ["embed/table"], [(nm, tuple(v.shape[1:]), v.dtype)
                                    for nm, v in stacks.items()], 4,
                  topology=build_topology(4, HIER_NODE))
    synced, stats = gs(stacks)
    assert {"sync/intra_words", "sync/inter_words"} <= set(stats)
    for w, r in enumerate(ranks):
        for nm in names:
            np.testing.assert_array_equal(r[f"{key}/{nm}"][0],
                                          synced[nm][w].numpy(),
                                          err_msg=f"{nm} rank {w}")
        assert set(k.split("_stats/")[1] for k in r
                   if k.startswith(f"{key}_stats/")) == set(stats)
        for k, v in stats.items():
            np.testing.assert_array_equal(r[f"{key}_stats/{k}"],
                                          v[w:w + 1].float().numpy(),
                                          err_msg=f"{k} rank {w}")
    sim = ranks[0]
    assert np.isfinite(sim["hsim/loss"]).all()
    assert sim["hsim/sync/overflow"].tolist() == [0.0] * STEPS
    for w, r in enumerate(ranks):
        for k in ("sync/overflow", "sync/sparse_sent_words", "embed"):
            np.testing.assert_array_equal(r[f"htrainer/{k}"],
                                          sim[f"hsim/{k}"],
                                          err_msg=f"{k} rank {w}")
        # the reported loss is a mean over all 4 ranks (the world, not a
        # level), whose gloo all_reduce adds in its own order: each side
        # is within 3 u of the exact mean of the 4 positive losses
        np.testing.assert_allclose(r["htrainer/loss"], sim["hsim/loss"],
                                   rtol=6 * U["f32"], atol=0,
                                   err_msg=f"loss rank {w}")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _step_losses(text: str) -> list[str]:
    return [ln.split("loss=")[1].split()[0] for ln in text.splitlines()
            if ln.startswith("step ")]


def test_torchrun_cli_prints_the_in_process_losses(groups, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # as torchrun's ranks run
    try:
        local = train.main(CLI)
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    cli = groups["cli"]
    rc, log = cli.wait()[0], cli.log(0)
    assert rc == 0, log[-4000:]
    assert _step_losses(log) == _step_losses(printed), log[-4000:]
    assert len(_step_losses(log)) == 2
    # rank 0 alone prints; its result is the in-process run's, exactly
    assert sum(ln == "done" for ln in log.splitlines()) == 1
    res = [ln for ln in log.splitlines() if ln.startswith("dist result ")]
    assert len(res) == 1
    dres = json.loads(res[0][len("dist result "):])
    assert dres["losses"] == local["losses"]
    assert dres["sparse_words"] == local["sparse_words"]
    assert dres["plain_calls"] == local["plain_calls"]
    assert dres["launches_by_rank"]["zen_encode"] == [0, 0]


def test_zenlint_dist_group_bytes_equal_simgroup(groups):
    """Each rank's trace sweep over gloo is clean and records, case by
    case, the per-worker bytes the in-process sweep records."""
    from repro_torch.analysis.lint import run_trace_sweep
    findings, wires = run_trace_sweep(ns=(4,), M=LINT_M, verbose=False)
    assert not findings, [str(f) for f in findings]
    want = {f"{label}|{kind}|{g}": b for label, wire in wires.items()
            for (kind, g), b in wire.items()}
    for r, res in enumerate(groups[4]["ranks"].results()):
        assert list(res["lint/findings"]) == [""], (r, res["lint/findings"])
        got = dict(zip(res["lint/keys"].tolist(), res["lint/bytes"]))
        assert got == want, r


def test_mesh_larger_than_the_group_raises(groups):
    cli = groups["cli"]
    rc, log = cli.wait()[1], cli.log(1)
    assert rc != 0
    assert ("ValueError: mesh '4x1' has D=4 data-parallel ranks but the "
            "process group has 2") in log, log[-4000:]


def test_dist_without_torchrun_env_raises(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main([*CLI, "--dist", "gloo"])


def test_nccl_on_cpu_raises():
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        train.main([*CLI, "--dist", "nccl"])


def test_nccl_with_ranks_sharing_a_gpu_raises(monkeypatch):
    """Two ranks on a one-GPU machine: nccl raises before joining any
    group, and names gloo; it never switches backend by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl places one rank on each GPU"
                                         ".*--dist gloo"):
        make_data_group("nccl")
