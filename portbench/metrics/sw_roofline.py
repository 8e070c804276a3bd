"""Real DP cells of the traced window's alignments at the int32 count
(lib/work.py) over the device time of all kernels inside its rescoring
spans, in percent."""

from portbench.lib.work import sw_bound_s


def read(run):
    cells = run.info.get("cells")
    if run.trace is None or not cells:
        return None
    busy = sum(e - s for _, s, e in run.trace.kernels_in("align"))
    if busy <= 0:
        return None
    return 100.0 * sw_bound_s(sum(cells)) / busy
