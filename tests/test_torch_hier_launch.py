"""The launcher on two-level topologies and pod meshes (``launch/train.py
--mesh PxDx1 --node-size k``), beside tests/test_torch_hier.py's parity
cases in a file of their own, so that the parallel runner can put these
long runs on another worker.

* ``--mesh 2x4x1 --node-size 2`` trains and reports each level's words; a
  node size that does not divide D raises;
* ``--replan-every`` with ``--sync auto --compress`` on nodes of 2 rebuilds
  the plan from the measured densities.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs in parallel workers,
    where torch's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def test_launcher_runs_pods_and_node_size():
    """``--mesh 2x4x1 --node-size 2`` trains and reports each level's
    words; a node size that does not divide D raises the reference's
    message."""
    base = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "2",
            "--seq-len", "16", "--global-batch", "8", "--log-every", "1",
            "--device", "cpu"]
    out = train.main(base + ["--mesh", "2x4x1", "--node-size", "2",
                             "--alpha-beta", "1,4e-5,10,4e-4"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert len(out["intra_words"]) == 2 and out["intra_words"][0] > 0
    assert out["inter_words"][0] > 0 and out["overflow"] == 0
    assert out["plan"][0].startswith("topology: dp_inter[2]")
    with pytest.raises(ValueError, match="does not divide the data axis"):
        train.main(base + ["--mesh", "8x1", "--node-size", "3"])


def test_launcher_replans_on_a_two_level_topology():
    """``--replan-every`` with ``--sync auto --compress``: the density
    controller prices the measured densities on the two-level topology
    (threshold:0 keeps every element, so the large compressed buckets
    flip to two-level dense) and the plan is rebuilt at step 2."""
    out = train.main(["--arch", "qwen2-0.5b", "--reduced", "--mesh", "4x1",
                      "--node-size", "2", "--sync", "auto", "--compress",
                      "threshold:0", "--replan-every", "2", "--steps", "3",
                      "--seq-len", "16", "--global-batch", "4",
                      "--log-every", "1", "--device", "cpu"])
    assert out["replans"] == [2]
    plans = [ln for ln in out["plan"] if "compress=" in ln]
    assert any("plan=[dense@dp_intra[2] ; dense@dp_inter[2]]" in ln
               for ln in plans)
    assert np.isfinite(out["losses"]).all() and len(out["inter_words"]) == 3
