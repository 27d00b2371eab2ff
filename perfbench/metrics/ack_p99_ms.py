"""The 99th percentile of a request's time from its submit call to its
future resolving, over every request completed in the window, on the
host's clock."""

import numpy as np


def read(run):
    if not len(run.latency_s):
        return None
    return float(np.percentile(run.latency_s, 99)) * 1e3
