"""``query_p95_ms`` (ms): the 95th percentile (linear between order
statistics) of every latency of the window, each from a query's send to
all its results in hand."""

import numpy as np


def read(summary: dict):
    lat = summary.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
