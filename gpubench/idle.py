"""Idle time of a traced window put down to the program's spans.

The port records host spans on the profiler's clock (``time.time_ns()``;
pilotguru_tpu_torch/utils/profiling.py), so each idle nanosecond of the
device's timeline can be put down to what the host was doing then: the
innermost span that covers it, by overlap, so a gap that runs across a
span's end is split between the spans on either side. Idle time that no
span covers is put down to none.

``RecordingTrace`` is the cell's device trace with the port's recorder
installed from its start to its stop, and ``attribution`` turns one traced
run into the figures ``profile_training.py`` prints beside the result line.
No reader of the benchmark reads them yet: the PilotNet cells install no
recorder (PERF.md, Open questions).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from gpubench.devtrace import DeviceTrace, Interval, gaps, merge

Span = Tuple[str, int, int]  # (name, start_ns, end_ns)


def idle_by_span(events: Sequence[Interval], spans: Sequence[Span], lo: int,
                 hi: int) -> List[int]:
    """Idle ns of [lo, hi] under each span as the innermost one covering it,
    in the order of ``spans``, then the idle ns no span covers: one entry
    more than ``spans``, summing to the window's idle time. ``events`` are
    device intervals on any stream (their union is the busy time). Of the
    spans covering an instant, the innermost is the one that started last
    (the shorter on a tie), which is the innermost where spans nest."""
    out = [0] * (len(spans) + 1)
    points = sorted((t, kind, i) for i, (_, start, end) in enumerate(spans) if end > start
                    for t, kind in ((start, 1), (end, 0)))  # an end before a start at one t
    open_spans: dict = {}
    cursor = 0

    def innermost() -> int:
        if not open_spans:
            return len(spans)
        return max(open_spans, key=lambda i: (spans[i][1], -spans[i][2]))

    def advance(t: int) -> None:
        nonlocal cursor
        while cursor < len(points) and points[cursor][0] <= t:
            _, kind, i = points[cursor]
            if kind:
                open_spans[i] = True
            else:
                open_spans.pop(i, None)
            cursor += 1

    for start, end in gaps(merge(events, lo, hi), lo, hi):
        t = start
        advance(t)
        while t < end:
            step = min(end, points[cursor][0]) if cursor < len(points) else end
            out[innermost()] += step - t
            t = step
            advance(t)
    return out


BATCH, EPOCH_END = "train.batch", "train.epoch_end"


class RecordingTrace(DeviceTrace):
    """The cell's device trace, with the port's recorder installed from its
    start to its stop; keeps the harness's spans that summary() is given.
    ``last`` is the newest one made."""

    last = None

    def __init__(self):
        from pilotguru_tpu_torch.utils import profiling

        super().__init__()
        self.timer = profiling.StageTimer("window")
        self._recording = profiling.recording(self.timer)
        self.harness_spans, self.summarized = [], None
        RecordingTrace.last = self

    def start(self) -> None:
        super().start()
        self._recording.__enter__()

    def stop(self) -> None:
        self._recording.__exit__(None, None, None)
        super().stop()

    def summary(self, spans, outside):
        self.harness_spans = list(spans.items)
        self.summarized = super().summary(spans, outside)
        return self.summarized


def category(spans, i: int) -> str:
    """``batch`` under train.batch, ``epoch_end`` under train.epoch_end,
    ``other`` otherwise (harness spans and no span included)."""
    while 0 <= i < len(spans):
        if spans[i].name == BATCH:
            return "batch"
        if spans[i].name == EPOCH_END:
            return "epoch_end"
        i = spans[i].parent
    return "other"


def attribution(trace: RecordingTrace) -> dict:
    """The idle shares under ``train.batch``, under ``train.epoch_end`` and
    the rest (%, of the window; they sum to the idle share), the host's
    batch ms a step, the host-to-device GB/s, the idle ms under each span
    name, the recorder's tallies, each stage's count, summed ms and self ms,
    and the longest idle gaps named by program span."""
    timer, lo, hi = trace.timer, trace.start_ns, trace.stop_ns
    program = [(s.name, s.start_ns, s.end_ns) for s in timer.spans]
    spans = program + trace.harness_spans
    events = [(s, e) for _, s, e in trace.events]
    idle = idle_by_span(events, spans, lo, hi)
    window = hi - lo
    shares = {"batch": 0, "epoch_end": 0, "other": 0}
    by_name: dict = {}
    for i, ns in enumerate(idle):
        name = spans[i][0] if i < len(spans) else "no span"
        shares[category(timer.spans, i) if i < len(program) else "other"] += ns
        by_name[name] = by_name.get(name, 0) + ns
    tallies = dict(timer.tallies)
    h2d_s = sum(seconds for name, (_, seconds) in trace.summarized.by_name.items()
                if name.startswith("Memcpy HtoD"))
    steps = tallies.get("train.steps", 0)
    out = {f"train_idle_{key}_share": 100.0 * ns / window for key, ns in shares.items()}
    if steps:
        out["train_host_batch_ms_per_step"] = 1e3 * timer.stages.get(BATCH, 0.0) / steps
    if h2d_s and tallies.get("train.h2d_bytes"):
        out["train_h2d_gb_per_s"] = tallies["train.h2d_bytes"] / h2d_s / 1e9
    out["idle_ms_by_span"] = {k: v / 1e6 for k, v in sorted(by_name.items(),
                                                             key=lambda kv: -kv[1])}
    out["tallies"] = tallies
    own: dict = {}
    for span, ns in zip(timer.spans, timer.self_ns()):
        own[span.name] = own.get(span.name, 0) + ns
    out["stages"] = {k: [timer.counts[k], 1e3 * timer.stages[k], own[k] / 1e6]
                     for k in timer.order}
    out["idle_gaps"] = longest_gaps(events, program, lo, hi)
    return out


def longest_gaps(events, program, lo, hi, n: int = 10) -> list:
    """The n longest idle gaps, each named by the program span under which
    most of it lies ('no span' where none): [name@offset_ms, seconds]."""
    out = []
    for a, b in sorted(gaps(merge(events, lo, hi), lo, hi), key=lambda g: g[0] - g[1])[:n]:
        idle = idle_by_span([], program, a, b)
        k = max(range(len(idle)), key=idle.__getitem__)
        name = program[k][0] if k < len(program) else "no span"
        out.append([f"{name}@{(a - lo) / 1e6:.3f}ms", (b - a) / 1e9])
    return out
