"""Reads the lease fast path served from the host mirrors, as a share of
the reads that tried it in the window (the service's
``read_fastpath_hits`` and ``_misses``)."""


def read(run):
    h = run.stats1["read_fastpath_hits"] - run.stats0["read_fastpath_hits"]
    m = (run.stats1["read_fastpath_misses"]
         - run.stats0["read_fastpath_misses"])
    if h + m <= 0:
        return None
    return 100.0 * h / (h + m)
