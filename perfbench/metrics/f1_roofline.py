"""F1's share of its roofline over the traced window: the sum of each
launch's bound (:func:`perfbench.f1_bytes.launch_bound`: its bytes at the
HBM peak, or its design's int32 operations at the int32 peak, whichever
is longer) over F1's device time by kernel name in the trace.  Nothing
when the trace and the recorder disagree on the launch count."""

from perfbench import trace as tr


def read(run):
    if run.trace is None or not run.f1:
        return None
    dev_s, n = tr.kernel_time(run.trace, tr.F1_KERNEL)
    if n != len(run.f1) or dev_s <= 0:
        return None
    return 100.0 * sum(b["bound_s"] for b in run.f1) / dev_s
