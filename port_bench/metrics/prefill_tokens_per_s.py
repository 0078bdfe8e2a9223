"""Prompt tokens prefilled a second: every token of the batches the window
served over the window's time on the host's clock."""

UNIT, SOURCE = "tokens/s", "host_clock"


def read(run):
    if run.kind != "prefill" or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
