"""``idle_share`` (%, layer: device): the share of a step's wall time in
which no operation ran on the device, 100 x (1 - busy / step): busy the
device's busy seconds a traced step, from the profiler's trace (the union
of every device operation's interval), and the step the untraced window's
seconds a step (host clock, ending in a device sync).  The profiler slows
the host, so the traced steps' own wall time would count its overhead as
idle.  Moves ``train_tokens_per_s``."""
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    w = rec.get("window")
    if not rec.get("busy_s") or not rec.get("traced_steps") or not w \
            or not w.get("steps"):
        return None
    busy = rec["busy_s"] / rec["traced_steps"]
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))
