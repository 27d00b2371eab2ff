"""The enqueue half per flush in the window: ``h2d`` + ``dispatch`` of the
service's latency records, averaged over the flushes."""


def read(run):
    recs = [r for r in run.lat_records if "h2d" in r]
    if not recs:
        return None
    return sum(r["h2d"] + r.get("dispatch", 0.0) for r in recs) \
        / len(recs) * 1e3
