"""The all-vs-all pass's int8 product bound (every row against every row)
over the device time of all kernels inside its passes, in percent."""

from portbench.lib.work import int8_search_bound_s


def read(run):
    if run.trace is None:
        return None
    busy = sum(e - s for _, s, e in run.trace.kernels_in("pass"))
    if busy <= 0:
        return None
    passes = len(run.trace.named_spans("pass"))
    rows, dim = run.info["rows"], run.info["dim"]
    bound = passes * int8_search_bound_s(rows, rows, dim, run.cell["k"])
    return 100.0 * bound / busy
