"""The program's own spans (knn_for_homology_tpu_torch/utils/trace.py) in a
traced window, set beside the benchmark's spans and the device trace.

The program records its spans while the window's profiler runs, on the
host clock the profiler stamps its events with. A program without the
trace module, or whose spans do not sit inside the benchmark's spans
around the same calls, gives no spans here, and the readers built on them
give no number.
"""

import bisect
import weakref
from typing import Dict, List, Optional

from .record import idle_gaps

# a program span's name -> the benchmark's spans around the calls it times
HOLDERS = {"embed": ("embed",), "flat.search": ("search", "pass")}
TOLERANCE_S = 0.5e-3

# (a weak reference to the last run read, its program spans): the program
# hands its spans over once, and every reader of that run shares them
_last = (lambda: None, None)


def recorded_spans() -> Optional[list]:
    """The spans the program recorded since they were last taken, which
    empties its buffer (None where the program has no trace module)."""
    try:
        from knn_for_homology_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans()


def clock_agrees(trace, spans) -> bool:
    """True where every program span named in HOLDERS lies within a
    benchmark span around the same call to TOLERANCE_S, and one at least
    was checked."""
    checked = 0
    for name, holders in HOLDERS.items():
        outer = sorted((s, e) for n, s, e in trace.spans if n in holders)
        starts = [s for s, _ in outer]
        for sp in spans:
            if sp.name != name:
                continue
            at = bisect.bisect_right(starts, sp.t0 + TOLERANCE_S) - 1
            if at < 0 or sp.t0 < outer[at][0] - TOLERANCE_S \
                    or sp.t1 > outer[at][1] + TOLERANCE_S:
                return False
            checked += 1
    return checked > 0


def program_spans(run) -> Optional[list]:
    """The program's spans that start inside the traced window, once their
    clock agrees with the trace's; else None. Taken and checked once a run."""
    global _last
    if _last[0]() is run:
        return _last[1]
    spans = recorded_spans() if run.trace is not None else None
    inside = None
    if spans is not None:
        lo, hi = run.trace.window
        inside = [sp for sp in spans if lo <= sp.t0 <= hi]
        if not clock_agrees(run.trace, inside):
            inside = None
    _last = (weakref.ref(run), inside)
    return inside


def innermost(spans) -> List[tuple]:
    """[(start, end, name)], sorted: the stretches in which each span is the
    innermost one open (the spans nest, as one thread's do)."""
    out, stack, at = [], [], None  # stack: (name, end)

    def close_until(t):
        nonlocal at
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > at:
                out.append((at, end, name))
                at = end

    for sp in sorted(spans, key=lambda sp: (sp.t0, -sp.t1)):
        close_until(sp.t0)
        if stack and sp.t0 > at:
            out.append((at, sp.t0, stack[-1][0]))
        at = sp.t0
        stack.append((sp.name, sp.t1))
    close_until(float("inf"))
    return out


def idle_by_span(run, spans) -> Dict[str, float]:
    """{span name: idle seconds}: each idle second of the window goes to
    the innermost program span open at that instant, "" where none was."""
    pieces = innermost(spans)
    idle, j = {}, 0
    for s, e in idle_gaps(run.trace):
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part
                covered += part
            k += 1
        idle[""] = idle.get("", 0.0) + (e - s) - covered
    return idle
