"""``step_mfu`` (%, layer: the train step, ``train/steps.py``): the model
FLOPs of a step (``harness/yardstick.train_step_flops``: 6 x the matrix
parameters the tokens pass, the head included, x the tokens, plus causal
attention; recomputation not counted) over the step time of the traced
run's untraced window (host clock, ending in a device sync) and the
card's bf16 peak.  Moves ``train_tokens_per_s``."""
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(rec: dict):
    w, peaks = rec.get("window"), rec.get("peaks")
    if not w or not peaks or not rec.get("flops_per_step"):
        return None
    step_s = w["seconds"] / w["steps"]
    return 100.0 * rec["flops_per_step"] / step_s / peaks["bf16"]
