"""Host time inside the keyed verbs (``kput_many`` / ``kget_many``) per op
submitted in the window, by the benchmark's clock around each call."""


def read(run):
    if not run.submit_ops:
        return None
    return run.submit_s / run.submit_ops * 1e6
