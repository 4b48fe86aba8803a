"""``flash_fwd_roofline`` (%, layer: the kernels, ``csrc/flash_fwd.cu``):
the traced ``flash_fwd`` launches' least time, summed
(``harness/yardstick.flash_fwd_bound`` of each call's shapes: the larger
of its products over the bf16 peak and its bytes over HBM), over their
device time, summed.  Moves ``train_tokens_per_s``."""
from harness import yardstick

UNIT = "%"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    peaks = rec.get("peaks")
    calls = [c for c in rec.get("calls", ()) if c["name"] == "flash_fwd"]
    busy = sum(s for k, s in rec.get("kernels", {}).items()
               if "flash_fwd" in k)
    if not peaks or not calls or not busy:
        return None
    return 100.0 * sum(yardstick.flash_fwd_bound(c, peaks)
                       for c in calls) / busy
