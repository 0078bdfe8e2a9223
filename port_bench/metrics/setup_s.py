"""Seconds from the process's start to the window's: imports, drawing the
weights and data, building the kernels where the checkout has none, and
the warm-up (training: the checked steps)."""

UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
