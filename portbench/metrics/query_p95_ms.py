"""The 95th percentile of every answered query's latency in the window, from
the call to the answer on the host (host clock)."""

import numpy as np

UNIT = "ms"


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 95)) if run.latencies else None
