"""Queries whose final results reached the host, over the window's time
from its start to the end of its last completed call."""


def read(run):
    if "queries" not in run.calls[0]:
        return None
    return run.total("queries") / run.window_s()
