"""Time the interpreter spent in garbage collections during the window
(``gc.callbacks``), per second of the window."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.gc_pause_s * 1e3 / run.window_s
