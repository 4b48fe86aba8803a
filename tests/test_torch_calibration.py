"""Measured-cost calibration of the port (``core/costmodel.py``:
``CalibrationTable``, ``plan_encode_overhead``, ``CostCalibrator``; its
consumers ``choose_scheme`` / ``choose_plan``, ``GradSync(calib_file=)``,
``DensityController(calib=)`` and ``launch/train.py --calib-file``)
against the reference's (``repro.core.costmodel``) on the same JSON
entries, keyed by the port's backend ``"cuda"``, version 2.

* the lookups (``encode_us``, ``commit_us``, ``beta_us_per_word``) and
  ``plan_encode_overhead`` are bitwise the reference's over a grid of
  sizes, densities and plans, and the decisions with ``calib=`` are the
  reference's over int, flat and two-level targets;
* the properties of ``tests/test_calibration.py``, on fixed grids (that
  file draws them with hypothesis, which this host may not have): the
  identity table degenerates to the analytic argmin, encode overhead only
  flips zen to dense, an encode-dominant table flips flat to dense and
  prices zen plans out on two levels, the nearest lookup works in log
  space, the JSON round-trips (and the reference reads the port's file),
  a wrong version is rejected;
* a table of the reference's backends (``"xla"``, ``"pallas"``) is
  refused on load;
* ``CostCalibrator(backend="torch", device="cpu")`` measures an element
  point and a row point and round-trips; ``n < 2`` raises;
* ``GradSync(SyncConfig(scheme="auto", calib_file=F))`` plans the
  reference's buckets from the same file (flat and on nodes of 2), and
  ``DensityController(calib=)`` replays the reference's re-plan
  decisions over a stream of densities;
* ``launch/train.py --calib-file`` on a missing file calibrates, writes
  the table and trains on the CPU.
"""
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import costmodel as rcm
from repro.core import sparsify as rsp
from repro.core import topology as rtp
from repro.core.zen import GradSync as RefGradSync
from repro.core.zen import SyncConfig as RefSyncConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import sparsify as sp
from repro_torch.core import topology as tp
from repro_torch.core.zen import GradSync, SyncConfig
from repro_torch.launch import train

ENTRIES = [
    dict(backend="cuda", size=4096, density=0.01, n=8, encode_us=38.5,
         commit_us=51.25, zen_us=1210.0, dense_us=92.0),
    dict(backend="cuda", size=65536, density=0.1, n=8, encode_us=61.0,
         commit_us=88.5, zen_us=1630.5, dense_us=140.25),
    dict(backend="torch", size=136134656, density=0.003, n=8,
         encode_us=10530.0, commit_us=4100.0, zen_us=51000.0,
         dense_us=46000.0, rows=151936, width=896),
]
SIZES = (1, 1000, 4096, 10_000, 65536, 1 << 20, 136_134_656)
DENSITIES = (1e-4, 0.003, 0.01, 0.05, 0.1, 0.5, 1.0)
TOPOS = ((2, 2), (2, 4), (4, 2), (8, 4))


def both(entries=ENTRIES):
    return (cm.CalibrationTable(entries=[dict(e) for e in entries]),
            rcm.CalibrationTable(entries=[dict(e) for e in entries]))


def profiles(mod, seed: int = 0, count: int = 30):
    """A fixed grid of profiles (``tests/test_calibration.py``'s family)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m = 1 << int(rng.integers(10, 23))
        d1, gamma = float(rng.uniform(1e-4, 0.9)), float(rng.uniform(0.05, 1))
        skew = float(rng.uniform(0, 2))

        def d(i, d1=d1, gamma=gamma):
            return min(1.0, d1 * max(i, 1) ** gamma)

        def s(k, skew=skew):
            return 1.0 + skew * math.log2(max(k, 1))

        out.append(mod.SparsityProfile(
            M=m, d=d, s=s, block=256,
            block_density=lambda i, d=d: min(1.0, d(i) * 256),
            block_max=lambda i, parts, d=d, s=s: min(1.0, d(i) * 256
                                                     * s(parts))))
    out += [mod.worst_case_profile(151936, 0.25, vw=896),
            mod.worst_case_profile(1 << 14, 0.01),
            mod.worst_case_profile(13_074_432, 0.04)]
    return out


def synthetic(encode_us: float = 1e9, *, n: int = 8, size: int = 1 << 14,
              density: float = 0.01, dense_us: float = 100.0):
    """One-entry table, every key; the default encode dwarfs any wire."""
    return cm.CalibrationTable(entries=[dict(
        backend="cuda", size=size, density=density, n=n,
        encode_us=encode_us, commit_us=0.0, zen_us=encode_us,
        dense_us=dense_us)])


# ---------------------------------------------------------------------------
# the reference's lookups and decisions, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["zen", "dense", "agsparse"])
def test_lookups_are_the_references(scheme):
    t, r = both()
    for size in SIZES:
        assert t.beta_us_per_word(size) == r.beta_us_per_word(size)
        for d in DENSITIES:
            assert t.encode_us(scheme, size, d) == r.encode_us(scheme, size, d)
            assert t.commit_us(scheme, size, d) == r.commit_us(scheme, size, d)


@pytest.mark.parametrize("shape", TOPOS)
def test_plan_encode_overhead_is_the_references(shape):
    t, r = both()
    ttopo, rtopo = tp.two_level_topology(*shape), rtp.two_level_topology(*shape)
    for tprof, rprof in zip(profiles(cm), profiles(rcm)):
        tplans = cm.candidate_plans(ttopo, tprof.M)
        rplans = rcm.candidate_plans(rtopo, rprof.M)
        assert [p.tag() for p in tplans] == [p.tag() for p in rplans]
        for tpl, rpl in zip(tplans, rplans):
            assert (cm.plan_encode_overhead(t, tpl, tprof, ttopo)
                    == rcm.plan_encode_overhead(r, rpl, rprof, rtopo))


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_decisions_with_calib_are_the_references(threshold):
    t, r = both()
    flips = 0
    for tprof, rprof in zip(profiles(cm), profiles(rcm)):
        for n in (2, 4, 8, 16):
            got = cm.choose_scheme(tprof, n, threshold=threshold, calib=t)
            assert got == rcm.choose_scheme(rprof, n, threshold=threshold,
                                            calib=r)
            flips += got != cm.choose_scheme(tprof, n, threshold=threshold)
            assert (cm.choose_scheme(tprof, tp.flat_topology(n),
                                     threshold=threshold, calib=t)
                    == rcm.choose_scheme(rprof, rtp.flat_topology(n),
                                         threshold=threshold, calib=r))
        for shape in TOPOS:
            got = cm.choose_plan(tprof, tp.two_level_topology(*shape),
                                 threshold=threshold, calib=t).tag()
            assert got == rcm.choose_plan(
                rprof, rtp.two_level_topology(*shape), threshold=threshold,
                calib=r).tag()
            assert got == cm.choose_scheme(
                tprof, tp.two_level_topology(*shape), threshold=threshold,
                calib=t)
    assert flips   # the table moves some decisions


# ---------------------------------------------------------------------------
# the properties of tests/test_calibration.py
# ---------------------------------------------------------------------------

def test_identity_degenerates_to_the_analytic_decision():
    ident = cm.CalibrationTable.identity()
    for p in profiles(cm, seed=1):
        for n in (2, 4, 8, 16, 64):
            assert cm.choose_scheme(p, n, calib=ident) == cm.choose_scheme(p, n)
            topo = tp.flat_topology(n)
            assert (cm.choose_scheme(p, topo, calib=ident)
                    == cm.choose_scheme(p, topo)
                    == cm.choose_scheme(p, n, calib=ident))
        for shape in TOPOS:
            topo = tp.two_level_topology(*shape)
            measured = cm.choose_plan(p, topo, calib=ident)
            assert measured.tag() == cm.choose_plan(p, topo).tag()
            times = cm.plan_times(p, topo)
            times.pop("lower_bound")
            assert times[measured.tag()] <= min(times.values()) * (1 + 1e-12)
            for plan in cm.candidate_plans(topo, p.M):
                assert cm.plan_encode_overhead(ident, plan, p, topo) == 0.0


def test_encode_overhead_never_flips_dense_to_zen():
    for p in profiles(cm, seed=2):
        for n in (2, 4, 8):
            for enc in (0.0, 1.0, 1e3, 1e7):
                table = synthetic(enc, n=n, size=p.M * p.vw, density=p.d(1))
                if cm.choose_scheme(p, n) == "dense":
                    assert cm.choose_scheme(p, n, calib=table) == "dense"


def test_encode_dominant_table_flips_flat_to_dense_and_prices_zen_out():
    p = cm.worst_case_profile(1 << 14, 0.01)
    table = synthetic()
    assert cm.choose_scheme(p, 8) == "zen"
    assert cm.choose_scheme(p, 8, calib=table) == "dense"
    assert cm.choose_scheme(p, tp.flat_topology(8)) == "zen"
    assert cm.choose_scheme(p, tp.flat_topology(8), calib=table) == "dense"
    topo = tp.two_level_topology(4, 2)
    cands = cm.candidate_plans(topo, p.M)
    dense_t = cm.plan_time(cands[0], p, topo)
    for plan in cands:
        if any(s.scheme == "zen" for s in plan.stages):
            assert (cm.plan_time(plan, p, topo)
                    + cm.plan_encode_overhead(table, plan, p, topo)
                    > dense_t), plan.tag()
    assert all(s.scheme != "zen"
               for s in cm.choose_plan(p, topo, calib=table).stages)


def test_nearest_lookup_is_log_space_and_linear_in_size():
    table = cm.CalibrationTable(entries=[
        dict(backend="cuda", size=1 << 10, density=0.01, n=4,
             encode_us=10.0, commit_us=40.0, zen_us=10.0, dense_us=50.0),
        dict(backend="cuda", size=1 << 16, density=0.01, n=4,
             encode_us=640.0, commit_us=0.0, zen_us=640.0, dense_us=70.0)])
    assert table.encode_us("zen", 1 << 10, 0.01) == 10.0
    assert table.encode_us("zen", 1 << 16, 0.01) == 640.0
    assert table.encode_us("zen", 1 << 11, 0.01) == pytest.approx(20.0)
    assert table.encode_us("zen", 1 << 15, 0.01) == pytest.approx(320.0)
    assert table.commit_us("zen", 1 << 11, 0.01) == pytest.approx(80.0)
    assert table.encode_us("dense", 1 << 10, 0.01) == 0.0
    assert table.commit_us("dense", 1 << 10, 0.01) == 0.0
    ident = cm.CalibrationTable.identity()
    assert ident.encode_us("zen", 1 << 20, 0.01) == 0.0
    assert ident.commit_us("zen", 1 << 20, 0.01) == 0.0
    assert ident.beta_us_per_word(1 << 20) == 1.0


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def test_json_round_trips_and_the_reference_reads_it(tmp_path):
    table, _ = both()
    table.meta = {"backend": "cuda", "device": "NVIDIA H100 80GB HBM3"}
    path = tmp_path / "calib.json"
    table.save(path)
    back = cm.CalibrationTable.load(path)
    assert (back.entries, back.meta) == (table.entries, table.meta)
    ref = rcm.CalibrationTable.load(path)   # the same format, version 2
    assert (ref.entries, ref.meta) == (table.entries, table.meta)
    rcm.CalibrationTable(entries=ENTRIES, meta={"x": 1}).save(
        tmp_path / "ref.json")
    assert cm.CalibrationTable.load(tmp_path / "ref.json").entries == ENTRIES


@pytest.mark.parametrize("version", [1, 999])
def test_wrong_version_is_rejected(tmp_path, version):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": version, "entries": []}))
    with pytest.raises(ValueError, match="version"):
        cm.CalibrationTable.load(path)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_reference_backend_table_is_refused(tmp_path, backend):
    path = tmp_path / "ref.json"
    rcm.CalibrationTable(entries=[*ENTRIES[:1], dict(
        ENTRIES[1], backend=backend)]).save(path)
    with pytest.raises(ValueError, match=backend):
        cm.CalibrationTable.load(path)
    with pytest.raises(ValueError, match=backend):
        GradSync(SyncConfig(scheme="auto", calib_file=str(path)),
                 ["embed/table"], [("embed/table", (64, 4), torch.float32)],
                 4)


# ---------------------------------------------------------------------------
# the calibrator
# ---------------------------------------------------------------------------

def test_cost_calibrator_measures_and_round_trips(tmp_path):
    cal = cm.CostCalibrator(backend="torch", n=2, sizes=(1024, (256, 8)),
                            densities=(0.05,), iters=1, warmup=1,
                            device="cpu")
    table = cal.measure()
    assert [e["size"] for e in table.entries] == [1024, 2048]
    assert (table.entries[1]["rows"], table.entries[1]["width"]) == (256, 8)
    for e in table.entries:
        assert e["backend"] == "torch" and e["n"] == 2
        for key in ("encode_us", "commit_us", "zen_us", "dense_us"):
            assert math.isfinite(e[key]) and e[key] > 0.0, key
    assert table.meta["device"] == "cpu" and table.meta["backend"] == "torch"
    path = tmp_path / "measured.json"
    table.save(path)
    assert cm.CalibrationTable.load(path).entries == table.entries
    assert len(cm.flip_lines(table)) == 2


def test_cost_calibrator_rejects_degenerate_axis_and_backend():
    with pytest.raises(ValueError, match="n >= 2"):
        cm.CostCalibrator(n=1, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        cm.CostCalibrator(backend="xla", device="cpu")


# ---------------------------------------------------------------------------
# the consumers
# ---------------------------------------------------------------------------

CALIB = [dict(backend="cuda", size=s, density=d, n=4, encode_us=e,
              commit_us=c, zen_us=3 * e, dense_us=z)
         for s, d, e, c, z in ((1024, 0.05, 4000.0, 900.0, 30.0),
                               (65536, 0.05, 50.0, 20.0, 900.0),
                               (64000, 0.25, 45.0, 10.0, 900.0))]


def _shapes():
    """A sparse table beside dense leaves (compressed buckets)."""
    f32 = jnp.float32
    return {"embed": {"table": jax.ShapeDtypeStruct((4000, 16), f32)},
            "layers": {f"w{i:02d}": jax.ShapeDtypeStruct((size,), f32)
                       for i, size in enumerate((1024, 1024, 65536, 256))}}


def _leaves(shapes):
    return [("/".join(str(k.key) for k in path), tuple(s.shape),
             torch.float32)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@pytest.mark.parametrize("node_size", [1, 2])
def test_gradsync_plans_the_references_buckets(tmp_path, node_size):
    path = tmp_path / "calib.json"
    cm.CalibrationTable(entries=CALIB, meta={"device": "test"}).save(path)
    shapes = _shapes()
    cfg = dict(scheme="auto", density_budget=0.25, bucket_bytes=4096,
               compress="topk:0.05")
    n = 4
    ttopo = tp.build_topology(n, node_size)
    rtopo = rtp.build_topology(n, node_size)
    axis = "data" if node_size == 1 else ("dp_inter", "dp_intra")
    plans = {}
    for calib in (None, str(path)):
        gs = GradSync(SyncConfig(**cfg, calib_file=calib), ["embed/table"],
                      _leaves(shapes), n, topology=ttopo)
        ref = RefGradSync(RefSyncConfig(**cfg, calib_file=calib),
                          ["embed/table"], shapes, n, data_axis=axis,
                          topology=rtopo)
        assert gs.describe() == ref.describe()
        assert [b.scheme for b in gs.plan.buckets] == \
            [b.scheme for b in ref.plan.buckets]
        plans[calib] = [b.scheme for b in gs.plan.buckets]
        if calib:
            assert gs.calib.entries == CALIB
            assert gs.describe()[1].startswith("calibration: 3 measured")
    # on one level the table moves a choice; on two, agsparse wins either
    # way (only Zen pays the measured encode and commit)
    assert (plans[None] != plans[str(path)]) == (node_size == 1)


def test_density_controller_replays_the_references_replans():
    t_tab, r_tab = both(CALIB)
    sizes = {"b0": 1024, "b1": 65536, "b2": 64000}
    for topo in (None, (2, 2)):
        tt = None if topo is None else tp.two_level_topology(*topo)
        rt = None if topo is None else rtp.two_level_topology(*topo)
        cur = dict.fromkeys(sizes, "zen" if topo is None
                            else "hier(zen@intra,zen@inter)")
        t = sp.DensityController(sizes, cur, 4, ema=0.5, topology=tt,
                                 calib=t_tab)
        r = rsp.DensityController(sizes, cur, 4, ema=0.5, topology=rt,
                                  calib=r_tab)
        plain = sp.DensityController(sizes, cur, 4, ema=0.5, topology=tt)
        rng = np.random.default_rng(3)
        differs = 0
        for step in range(40):
            stats = {}
            for k in sizes:
                d1 = float(rng.uniform(0.0, 0.05 + step / 60))
                stats[sp.DENSITY1_KEY.format(key=k)] = d1
                stats[sp.DENSITYN_KEY.format(key=k)] = min(
                    1.0, d1 * float(rng.uniform(1, 4)))
            for c in (t, r, plain):
                c.observe(stats)
            assert t.schemes() == r.schemes()
            assert t.drifted() == r.drifted()
            differs += t.schemes() != plain.schemes()
            if step % 5 == 4:
                for c in (t, r, plain):
                    c.rebase(r.schemes())
        # flat, the calibrated controller re-plans otherwise; on two
        # levels agsparse wins either way
        assert bool(differs) == (topo is None)


@pytest.fixture
def one_thread():
    """One intra-op thread: the calibrator times many small CPU calls,
    which threads shared with other test workers slow down many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_launcher_calibrates_a_missing_file_and_trains(tmp_path, one_thread):
    path = tmp_path / "calib.json"
    res = train.main(["--arch", "qwen2-0.5b", "--reduced", "--mesh", "2x1",
                      "--sync", "auto", "--calib-file", str(path),
                      "--backend", "torch", "--device", "cpu", "--steps", "2",
                      "--seq-len", "32", "--global-batch", "4",
                      "--log-every", "1"])
    table = cm.CalibrationTable.load(path)
    assert len(table.entries) == 6
    assert {e["n"] for e in table.entries} == {2}
    assert {e["backend"] for e in table.entries} == {"torch"}
    assert res["plan"][1].startswith("calibration: 6 measured entries (cpu)")
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 2
    # a second run loads the table as it is
    again = train.main(["--arch", "qwen2-0.5b", "--reduced", "--mesh", "2x1",
                        "--sync", "auto", "--calib-file", str(path),
                        "--backend", "torch", "--device", "cpu", "--steps",
                        "1", "--seq-len", "32", "--global-batch", "4"])
    assert again["plan"] == res["plan"]
    assert cm.CalibrationTable.load(path).entries == table.entries
