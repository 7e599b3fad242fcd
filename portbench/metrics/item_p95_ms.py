"""The 95th percentile of the latencies of all items completed in the
window (numpy's linear interpolation), in milliseconds."""

import numpy as np


def read(r):
    if not r.latencies:
        return None
    return float(np.percentile(np.asarray(r.latencies), 95)) * 1e3
