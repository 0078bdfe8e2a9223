"""The SSD forward's least time at each call's shape
(``counts.bounds.ssd_bound``) over the device time of the kernels launched
inside the benchmark's range around ``kernels.ops.ssd``."""

from harness import readers

UNIT, SOURCE, LAYER = "%", "device_trace", "kernels"
MOVES = "prefill_tokens_per_s"


def read(run):
    return readers.ssd_roofline(run, "prefill", "fwd")
