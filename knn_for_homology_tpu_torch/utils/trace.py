"""Spans of the program's own work, recorded while a torch.profiler runs.

To see where a call spends its time, run it under a profiler session and
take the session's spans afterwards::

    from torch.profiler import ProfilerActivity, profile
    from knn_for_homology_tpu_torch.utils import trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        embedder.embed_pooled(sequences)
    for s in trace.spans():
        print(s.name, s.t1 - s.t0, s.counts)

`spans()` hands the records over and empties the buffer, so each session
read this way sees its own spans only. Times are seconds on `time.time()`'s
clock, the clock on which the profiler stamps its host events and puts the
card's kernels, so a span can be set beside the trace's device intervals.
With no profiler running `span` returns one shared, falsy object that
records nothing, so the program pays one profiler-state check a span and
has no switch of its own; a count that costs work to take is taken under
`if sp:`. Spans are kept in memory only (no `record_function` range): a
range under the program's name would show in the trace as a device-side
annotation.
"""

import threading
import time
from typing import Dict, List, NamedTuple

import torch

CAPACITY = 1 << 20  # records kept between two calls of spans(); later ones dropped

_records: list = []  # Span, or None while the span is open
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    parent: int  # position of the enclosing span in spans(), -1 at the top
    call: int  # position of the outermost span of the same call
    t0: float  # seconds, time.time()'s clock
    t1: float
    counts: Dict[str, int]


class _Off:
    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **counts):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "records", "index", "parent", "call", "t0")

    def __init__(self, name, counts):
        self.name, self.counts, self.index = name, counts, -1

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        with _lock:
            self.records = _records
            if len(_records) < CAPACITY:
                self.index = len(_records)
                _records.append(None)
        # enclosing spans handed over by spans() meanwhile are not this one's
        outer = [sp.index for sp in stack if sp.records is self.records]
        self.parent = outer[-1] if outer else -1
        self.call = outer[0] if outer else self.index
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.stack.pop()
        if self.index >= 0:
            self.records[self.index] = Span(self.name, self.parent, self.call,
                                             self.t0 * 1e-9, t1 * 1e-9,
                                             self.counts)
        return None

    def count(self, **counts):
        self.counts.update(counts)


def span(name: str, **counts):
    """A context manager timing the block as `name`, with counts given here
    or through `.count(**counts)` before the block ends; it records only
    while a torch.profiler session runs, and is falsy when it does not."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _On(name, counts)


def spans() -> List[Span]:
    """Takes the spans recorded since the last call, in the order they were
    opened, and empties the buffer. Read it once a session has ended: the
    records stop at the first span still open."""
    global _records
    with _lock:
        out, _records = _records, []
    return out[:next((i for i, s in enumerate(out) if s is None), len(out))]
