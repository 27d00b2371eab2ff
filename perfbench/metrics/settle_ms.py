"""The settle half per flush in the window: ``unpack`` + ``resolve`` (the
unpack, mirrors and the completion fan-out) of the service's latency
records, averaged over the flushes."""


def read(run):
    recs = [r for r in run.lat_records if "unpack" in r]
    if not recs:
        return None
    return sum(r["unpack"] + r.get("resolve", 0.0) for r in recs) \
        / len(recs) * 1e3
