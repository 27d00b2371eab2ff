"""Acknowledged operations completed in the window, over its length, from
the clients' side (a failed or refused op is not acknowledged)."""


def read(run):
    return run.acked / run.window_s if run.window_s > 0 else None
