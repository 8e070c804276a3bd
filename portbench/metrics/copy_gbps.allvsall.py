"""Bytes that FlatIndex.search copied between host and card, over the
device seconds of the copies, in GB/s: the "bytes" of the window's
"flat.h2d" and "flat.d2h" spans over the Memcpy events (memsets left out)
that start inside those spans."""

import bisect

from portbench.lib.program import program_spans

COPIES = ("flat.h2d", "flat.d2h")


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    copies = sorted((sp.t0, sp.t1, sp.counts.get("bytes", 0))
                    for sp in spans if sp.name in COPIES)
    starts = [c[0] for c in copies]
    seconds = 0.0
    for name, s, e in run.trace.copies:
        at = bisect.bisect_right(starts, s) - 1
        if name.lower().startswith("memcpy") and at >= 0 \
                and s <= copies[at][1]:
            seconds += e - s
    if seconds <= 0:
        return None
    return sum(c[2] for c in copies) / seconds / 1e9
