"""The device's timeline from torch.profiler, and what the benchmark reads
from it: the union of busy intervals over every stream, kernel launches by
name, and the idle gaps labelled by what the harness saw the host doing.

Only CUDA activity is recorded (kernels, copies, sets), read back from the
profiler's raw results without building its per-event Python objects. The
profiler stamps events in nanoseconds of the wall clock, as time.time_ns()
does, so the harness's own spans line up with them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

Interval = Tuple[int, int]

COPY_PREFIXES = ("Memcpy", "Memset")


def union_length(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` (start, end) clipped to [lo, hi]:
    time in which at least one operation ran, on whatever stream."""
    merged = merge(intervals, lo, hi)
    return sum(end - start for start, end in merged)


def merge(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[int]] = []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def summed_length(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    """The sum of the clipped intervals' lengths, overlaps counted twice: the
    busy time a per-kernel total gives."""
    return sum(max(0, min(end, hi) - max(start, lo)) for start, end in intervals)


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of [lo, hi] between sorted disjoint ``busy``."""
    out, cursor = [], lo
    for start, end in busy:
        if start > cursor:
            out.append((cursor, start))
        cursor = max(cursor, end)
    if hi > cursor:
        out.append((cursor, hi))
    return out


@dataclass
class Spans:
    """Host spans the harness records around its calls into the program:
    (label, start_ns, end_ns), wall clock."""

    items: List[Tuple[str, int, int]] = field(default_factory=list)

    def add(self, label: str, start_ns: int, end_ns: int) -> None:
        self.items.append((label, start_ns, end_ns))

    def label_at(self, t_ns: int, outside: str) -> str:
        for label, start, end in self.items:
            if start <= t_ns < end:
                return label
        return outside


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    summed_s: float
    kernels: int  # kernel launches (copies and sets left out)
    by_name: dict  # name -> (launches, device seconds)
    device_ops: list  # the 10 names that took most device time: [name, seconds]
    idle_gaps: list  # the 10 longest idle gaps: [label@offset_ms, seconds]


class DeviceTrace:
    """A torch.profiler window over CUDA activity: start(), stop(); then
    summary()."""

    def __init__(self):
        self._prof = None
        self.start_ns = self.stop_ns = 0
        self.events: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.stop_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                start = e.start_ns()
                self.events.append((e.name(), start, start + e.duration_ns()))
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def summary(self, spans: Spans, outside: str) -> TraceSummary:
        return summarize(self.events, self.start_ns, self.stop_ns, spans, outside)


def summarize(events, lo: int, hi: int, spans: Spans, outside: str) -> TraceSummary:
    intervals = [(s, e) for _, s, e in events]
    busy = merge(intervals, lo, hi)
    by_name: dict = {}
    kernels = 0
    for name, s, e in events:
        launches, seconds = by_name.get(name, (0, 0.0))
        by_name[name] = (launches + 1, seconds + max(0, min(e, hi) - max(s, lo)) / 1e9)
        if not name.startswith(COPY_PREFIXES):
            kernels += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return TraceSummary(
        window_s=(hi - lo) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        summed_s=summed_length(intervals, lo, hi) / 1e9,
        kernels=kernels,
        by_name=by_name,
        device_ops=[[name, seconds] for name, (_, seconds) in top],
        idle_gaps=[[f"{spans.label_at((a + b) // 2, outside)}@{(a - lo) / 1e6:.3f}ms",
                    (b - a) / 1e9] for a, b in idle],
    )
