"""The benchmark's own spans around its calls into the program, and the
device trace of a traced window.

In a traced run each span is a `torch.profiler.record_function` range
named "pb:<name>", so the trace places it on the device's clock beside the
kernels; an untraced run records none.
"""

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Interval = Tuple[str, float, float]  # name, start s, end s


class Recorder:
    """The benchmark's spans around its calls into the program."""

    def __init__(self, traced: bool = False):
        self.traced = traced

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        import torch

        with torch.profiler.record_function("pb:" + name):
            yield


@dataclass
class DeviceTrace:
    """What the profiler saw of one window, in seconds on its own clock:
    device kernels, copies and memsets, and the benchmark's spans."""

    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)
    window: Optional[Tuple[float, float]] = None

    def named_spans(self, name: str) -> List[Interval]:
        return [s for s in self.spans if s[0] == name]

    def kernels_in(self, name: str) -> List[Interval]:
        """Kernels that start inside any span of this name."""
        spans = sorted((s, e) for _, s, e in self.named_spans(name))
        starts = [s for s, _ in spans]
        out = []
        for kernel in self.kernels:
            at = bisect.bisect_right(starts, kernel[1]) - 1
            if at >= 0 and kernel[1] <= spans[at][1]:
                out.append(kernel)
        return out

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or memset ran."""
        lo, hi = self.window
        return union_s([(s, e) for _, s, e in self.kernels + self.copies],
                       lo, hi)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end] intervals, clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def idle_gaps(trace: DeviceTrace):
    """[(start, end)] of the window's stretches with nothing on the device."""
    lo, hi = trace.window
    gaps, reach = [], lo
    for _, s, e in sorted(trace.kernels + trace.copies, key=lambda k: k[1]):
        if s > reach and s <= hi:
            gaps.append((reach, min(s, hi)))
        reach = max(reach, e)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    innermost span the host was in (mid-gap), each at most `top` long."""
    by_op = {}
    for name, s, e in trace.kernels + trace.copies:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    # spans of one name never overlap, so each name is a sorted list
    by_name = {}
    for name, s, e in sorted(trace.spans, key=lambda sp: sp[1]):
        if name != "window":
            by_name.setdefault(name, []).append((s, e))
    idle = {}
    for s, e in idle_gaps(trace):
        mid, label, width = (s + e) / 2, "between calls", float("inf")
        for name, spans in by_name.items():
            at = bisect.bisect_right(spans, (mid, float("inf"))) - 1
            if at >= 0 and mid <= spans[at][1]:
                if spans[at][1] - spans[at][0] < width:
                    label, width = name, spans[at][1] - spans[at][0]
        idle[label] = idle.get(label, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def read_profile(prof) -> DeviceTrace:
    """DeviceTrace of a finished torch.profiler.profile, from its kineto
    events (device kernels, copies and memsets; the "pb:" spans)."""
    from torch.autograd import DeviceType

    trace = DeviceTrace()
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        on_device = ev.device_type() == DeviceType.CUDA
        if name.startswith("pb:"):
            if not on_device:
                trace.spans.append((name[3:], start, end))
            continue
        if not on_device:
            continue
        lower = name.lower()
        if lower.startswith("memcpy") or lower.startswith("memset"):
            trace.copies.append((name, start, end))
        else:
            trace.kernels.append((name, start, end))
    windows = trace.named_spans("window")
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    trace.window = windows[0][1:]
    return trace
