"""``zen_roofline`` (%, layer: the kernels, ``csrc/zen_encode.cu``,
``csrc/zen_commit.cu``): the traced ``zen_encode``, ``zen_commit_push``
and ``zen_commit_pull`` launches' least time, summed (each call's bytes,
every input read once and every output written once, over HBM:
``harness/yardstick.io_bound``), over the device time of the Zen kernels
(``zen_*``), summed.  Moves ``train_tokens_per_s``."""
from harness import yardstick

UNIT = "%"
MOVES = "train_tokens_per_s"
CALLS = ("zen_encode", "zen_commit_push", "zen_commit_pull")


def read(rec: dict):
    peaks = rec.get("peaks")
    calls = [c for c in rec.get("calls", ()) if c["name"] in CALLS]
    busy = sum(s for k, s in rec.get("kernels", {}).items() if "zen_" in k)
    if not peaks or not calls or not busy:
        return None
    return 100.0 * sum(yardstick.io_bound(c, peaks) for c in calls) / busy
