"""query_p95_ms: the 95th percentile (linear between ranks) of the
latency of every query in the window, from the call to its answer on the
host as numpy."""

import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
