"""``attn_bwd_ms`` (ms, layer: the model, ``models/attention.py`` and
``ops.FlashAttn``'s plain backward): device milliseconds a step of the
operations launched under the harness's ``bench.attn_bwd`` span around
``FlashAttn.backward``, from the profiler's trace.  Moves
``train_tokens_per_s``."""
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    s = rec.get("spans", {}).get("bench.attn_bwd")
    if not s or not rec.get("traced_steps"):
        return None
    return 1e3 * s / rec["traced_steps"]
