"""The share of the traced window in which no operation ran on the device
(1 - busy / window, busy the union of the device operations' intervals in
the profiler's trace)."""

from harness import readers

UNIT, SOURCE, LAYER = "%", "device_trace", "device"
MOVES = "prefill_tokens_per_s"


def read(run):
    return readers.idle_pct(run, "prefill")
