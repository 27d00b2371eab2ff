"""The packed grid's mean occupancy (active columns' bucket over E) of the
launches that settled in the window: the change of the service's
``grid_occupancy`` x ``flushes`` over the change of ``flushes``."""


def read(run):
    s0, s1 = run.stats0, run.stats1
    n = s1["flushes"] - s0["flushes"]
    if n <= 0:
        return None
    occ = (s1["grid_occupancy"] * s1["flushes"]
           - s0["grid_occupancy"] * s0["flushes"]) / n
    return 100.0 * occ
