"""The card's peak allocated memory from a reset before the first warm-up
iteration to the end of the window (``torch.cuda.max_memory_allocated``),
in GiB."""

UNIT, SOURCE = "GiB", "host_clock"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
