"""query_p95_ms: the 95th percentile of every query of the window, each
from its submission to its result on the card, synchronised (host
clock): the nearest-rank value."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
