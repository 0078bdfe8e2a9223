"""Time to first token, 90th percentile (nearest rank) over every batch of
the window: from the batch's call to its last position's next tokens on
the host.  All of a batch's requests share its time."""

import math

UNIT, SOURCE = "ms", "host_clock"


def read(run):
    lat = sorted(run.latencies_s)
    if run.kind != "prefill" or not lat:
        return None
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
