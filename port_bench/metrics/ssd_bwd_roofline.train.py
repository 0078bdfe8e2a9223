"""The SSD backward's least time at each call's shape
(``counts.bounds.ssd_bwd_bound``) over the device time of the kernels
launched inside the benchmark's range around ``SsdScanFn.backward``."""

from harness import readers

UNIT, SOURCE, LAYER = "%", "device_trace", "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.ssd_roofline(run, "train", "bwd")
