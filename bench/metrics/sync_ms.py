"""``sync_ms`` (ms, layer: GradSync, ``core/zen.py``, ``core/schemes.py``,
``core/sparsify.py``): device milliseconds a step of the operations
launched under the harness's ``bench.sync`` span around
``GradSync.__call__`` (every bucket's compress, encode, exchange and
commit), from the profiler's trace.  Moves ``train_tokens_per_s``."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    s = rec.get("spans", {}).get("bench.sync")
    if not s or not rec.get("traced_steps"):
        return None
    return 1e3 * s / rec["traced_steps"]
