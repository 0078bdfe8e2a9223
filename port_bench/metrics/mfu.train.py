"""Model FLOPs of a training step (``counts.model_flops``: three forwards,
no recompute) over the step's time (steps just before the profiled ones,
on the host's clock) and the bf16 peak."""

from harness import readers

UNIT, SOURCE, LAYER = "%", "host_clock", "model step"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.mfu_pct(run, "train")
