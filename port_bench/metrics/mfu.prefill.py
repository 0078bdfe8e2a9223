"""Model FLOPs of a prefill (``counts.model_flops``) over the prefill's
time (prefills just before the profiled ones, on the host's clock) and the
bf16 peak."""

from harness import readers

UNIT, SOURCE, LAYER = "%", "host_clock", "model step"
MOVES = "prefill_tokens_per_s"


def read(run):
    return readers.mfu_pct(run, "prefill")
