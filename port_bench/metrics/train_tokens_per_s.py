"""Tokens trained a second: every token of the steps the window ran over
the window's time on the host's clock, which ends when the last step's
loss is on the host."""

UNIT, SOURCE = "tokens/s", "host_clock"


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
