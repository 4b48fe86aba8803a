"""A run with the timed path broken underneath comes out not correct:
each fault a training cell can have, planted in the port, at a tiny size
on the CPU.  The harness's look for a card is skipped (``run_cell`` on the
CPU); everything else of a run is driven as the command drives it."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import faults  # noqa: E402
from test_bench_harness import bench_copy, run_tiny  # noqa: E402


def _noop_update(cfg, p, g, st, step):
    """An optimizer step that leaves parameters and moments as they are."""


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny.dp8", "tiny-hd64.dp8"])
@pytest.mark.parametrize("fault", ["half_batch", "no_exchange",
                                   "small_unsynced", "small_zeroed",
                                   "state_unchanged"])
def test_a_fault_is_not_correct(tiny_bench, cell, fault, monkeypatch):
    from repro_torch.core.zen import GradSync
    from repro_torch.train import steps
    if fault == "state_unchanged":
        monkeypatch.setitem(steps.UPDATES, "adamw", _noop_update)
        r = run_tiny(tiny_bench, cell)
    else:
        with faults.FAULTS[fault](GradSync):
            r = run_tiny(tiny_bench, cell)
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert failed, r["checks"]
    if fault == "state_unchanged":   # reads 1 by its definition
        assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_the_same_cell_unbroken_is_correct(tiny_bench):
    assert run_tiny(tiny_bench, "tiny.dp8")["correct"] is True
