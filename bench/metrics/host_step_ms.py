"""``host_step_ms`` (ms, layer: the host, ``train/steps.py``'s
``step_fn``): the median over the traced run's untraced window of the
host's time from the call of ``prog.train_step`` to its return, with no
device sync: how long the host takes to enqueue a step.  Moves
``train_tokens_per_s``."""
import statistics

UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    w = rec.get("window")
    if not w or not w.get("host_step_s"):
        return None
    return 1e3 * statistics.median(w["host_step_s"])
