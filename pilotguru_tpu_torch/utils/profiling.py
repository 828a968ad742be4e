"""Per-stage wall-time reporting, spans and counters, and the profiler hook
(port of pilotguru_tpu/utils/profiling.py).

Pipelines wrap their phases in ``StageTimer`` scopes. Stages are stamped
with ``time.time_ns()``, the wall clock in which ``torch.profiler`` stamps
its host and device events, so a span lines up with a profiler trace
of the same process. A timer keeps every stage as a ``Span`` (name, start,
end, the enclosing open stage, a few attributes) besides its per-stage sums
and entry counts (``counts``), and ``count`` adds integers up into its
``tallies`` at the same boundaries.

Code deep in a call chain records through the ambient hook:
``stage(name, **attrs)`` and ``count(name, n)`` of this module go to the
timer that ``recording(timer)`` installed for the current thread, and do
nothing when none is installed. The training loop records so
(ml/training.py: ``train_models``; cli/hyperparams_search.py:
``run_training_group``):

- ``search.setup`` (the group's model, init, preload and weighters) and
  ``search.fold_logs`` (the per-fold logs written after training);
- ``train.epoch``, holding ``train.batch`` (the next batch's weights, its
  rows gathered on the host or, on CUDA devices, the wait for the worker
  that gathers them, and the host-to-device copies), ``train.step`` (the
  host's dispatch of the train step) and ``train.epoch_end``, which holds
  ``train.pull`` (losses to the host, the weighters' registration and
  step), ``train.validate``, ``train.checkpoint`` (best saves) and
  ``train.log``; after the epochs, ``train.checkpoint`` (the last saves);
- tallies ``train.steps``, ``train.skipped_batches`` (a batch no net
  trains on), ``train.val_batches``, ``train.checkpoints`` and
  ``train.h2d_bytes`` (the batch inputs, labels and weights handed to the
  devices); on CUDA devices also ``train.h2d_pinned_bytes`` (those bytes
  sent from pinned buffers on a copy stream) and ``train.staging_waits``
  (the host waiting for a staged batch; ml/staging.py).

Setting PILOTGURU_TPU_PROFILE_DIR captures a ``torch.profiler`` trace
(Chrome trace JSON, viewable in Perfetto) around a region wrapped in
``maybe_profiler_trace``, as the JAX package captures its profiler trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PROFILE_DIR_ENV = "PILOTGURU_TPU_PROFILE_DIR"


@dataclass
class Span:
    """One stage: wall-clock ns (``time.time_ns()``), the index of the
    stage that was open around it in its timer's ``spans`` (-1 for none),
    and the attributes it was opened with."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: Optional[dict] = None


@dataclass
class StageTimer:
    """Accumulates wall time per named stage (``stages``) and how many times
    each was entered (``counts``), and keeps each stage as a Span.
    ``count`` adds integers up under a name in ``tallies``.

    Usage:
        timer = StageTimer("fit_motion")
        with timer.stage("solve"):
            ...
        timer.report()
    """

    name: str
    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    tallies: Dict[str, int] = field(default_factory=dict)
    _open: List[int] = field(default_factory=list, init=False, repr=False)

    @contextlib.contextmanager
    def stage(self, stage_name: str, **attrs):
        start = time.time_ns()
        span = Span(stage_name, start, start, self._open[-1] if self._open else -1,
                    attrs or None)
        self._open.append(len(self.spans))
        self.spans.append(span)
        try:
            yield
        finally:
            end = span.end_ns = time.time_ns()
            self._open.pop()
            if stage_name not in self.stages:
                self.order.append(stage_name)
                self.stages[stage_name] = 0.0
                self.counts[stage_name] = 0
            self.stages[stage_name] += (end - start) / 1e9
            self.counts[stage_name] += 1

    def count(self, counter_name: str, n: int = 1) -> None:
        self.tallies[counter_name] = self.tallies.get(counter_name, 0) + n

    def self_ns(self) -> List[int]:
        """Each span's duration less the time its child spans cover."""
        out = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.end_ns - s.start_ns
        return out

    def total_seconds(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> Dict[str, float]:
        return {k: self.stages[k] for k in self.order}

    def report(self, out=None) -> str:
        lines = [f"[{self.name}] stage wall times:"]
        total = self.total_seconds()
        for stage_name in self.order:
            seconds = self.stages[stage_name]
            count = self.counts[stage_name]
            share = 100.0 * seconds / total if total > 0 else 0.0
            lines.append(
                f"  {stage_name:<24} {seconds * 1e3:10.1f} ms"
                f"  ({share:5.1f}%)  x{count}"
            )
        lines.append(f"  {'total':<24} {total * 1e3:10.1f} ms")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


# The timer that stage() and count() record into; a context variable, so a
# timer installed in one thread sees no other thread's stages.
_RECORDER: contextvars.ContextVar[Optional[StageTimer]] = contextvars.ContextVar(
    "pilotguru_profiling_recorder", default=None)
_NO_STAGE = contextlib.nullcontext()


@contextlib.contextmanager
def recording(timer: StageTimer):
    """Installs ``timer`` as the recorder of ``stage`` and ``count`` for the
    ``with`` block; the previous recorder (or none) after it."""
    token = _RECORDER.set(timer)
    try:
        yield timer
    finally:
        _RECORDER.reset(token)


def stage(stage_name: str, **attrs):
    """``timer.stage(stage_name, **attrs)`` of the installed recorder; with
    none, a shared context that does nothing."""
    timer = _RECORDER.get()
    if timer is None:
        return _NO_STAGE
    return timer.stage(stage_name, **attrs)


def count(counter_name: str, n: int = 1) -> None:
    """Adds ``n`` to the installed recorder's tally ``counter_name``; nothing
    without a recorder."""
    timer = _RECORDER.get()
    if timer is not None:
        timer.count(counter_name, n)


@contextlib.contextmanager
def maybe_profiler_trace(region_name: str = "pilotguru"):
    """Capture a ``torch.profiler`` trace of the region when
    PILOTGURU_TPU_PROFILE_DIR is set: host activity, and the cards'
    kernels and copies when CUDA is available, written on exit as
    ``<dir>/<region_name>/trace.json``. Unset, nothing is traced or
    written. It chooses no device and no code path."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    import torch

    target = os.path.join(profile_dir, region_name)
    os.makedirs(target, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, "trace.json"))
