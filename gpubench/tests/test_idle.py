"""Idle time put down to the innermost program span covering it, by
overlap; a small traced training run put down to the port's loop; and, on
the card, the program's spans and the device trace on one clock."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from gpubench import devtrace, harness, idle
from gpubench.drivers import pilotnet
from gpubench.idle import idle_by_span
from gpubench.tests.conftest import small_training

ROOT = Path(__file__).resolve().parents[2]


def test_overlapping_streams_nested_spans_and_idle_no_span_covers():
    # Two streams busy over [10, 30) and [25, 40); [60, 70) alone. Idle in
    # [0, 100): [0, 10), [40, 60), [70, 100) = 60 ns.
    events = [(10, 30), (25, 40), (60, 70)]
    spans = [("epoch", 5, 90), ("batch", 35, 55), ("pull", 80, 95)]
    idle = idle_by_span(events, spans, 0, 100)
    # epoch: [5, 10) + [55, 60) + [70, 80); batch: [40, 55) (nested in the
    # epoch, so innermost); pull: [80, 95) across the epoch's end;
    # none: [0, 5) and [95, 100).
    assert idle == [20, 15, 15, 10]
    busy = devtrace.union_length(events, 0, 100)
    assert sum(idle) == 100 - busy


def test_a_gap_is_split_by_overlap_not_given_to_its_midpoint():
    # One gap [10, 90): the span covers [10, 30) of it, nothing the rest.
    idle = idle_by_span([(0, 10), (90, 100)], [("step", 0, 30)], 0, 100)
    assert idle == [20, 60]


def test_shares_sum_to_the_idle_share():
    events = [(s, s + 7) for s in range(0, 1000, 10)] + [(3, 12), (500, 640)]
    spans = [("epoch", 0, 900), ("batch", 100, 160), ("step", 160, 170),
             ("epoch_end", 700, 900), ("validate", 720, 800), ("setup", 900, 1000)]
    idle = idle_by_span(events, spans, 0, 1000)
    summary = devtrace.summarize([("k", s, e) for s, e in events], 0, 1000,
                                 devtrace.Spans(), "outside")
    idle_share = 1 - summary.busy_s / summary.window_s
    batch = idle[1] / 1000
    epoch_end = (idle[3] + idle[4]) / 1000
    other = (idle[0] + idle[2] + idle[5] + idle[6]) / 1000
    assert abs(batch + epoch_end + other - idle_share) < 1e-12
    assert batch > 0 and epoch_end > 0 and other > 0


def test_equal_spans_and_an_empty_window():
    # Of two spans starting at the same instant the shorter is innermost.
    assert idle_by_span([], [("outer", 0, 10), ("inner", 0, 4)], 0, 10) == [6, 4, 0]
    assert idle_by_span([(0, 10)], [("s", 0, 10)], 0, 10) == [0, 0]


@pytest.mark.cuda
def test_a_kernel_in_a_program_span_lies_inside_it_on_the_trace(cuda_device):
    """The port's spans and the device trace share the wall clock: a kernel
    launched inside a program span, after a 5 ms host sleep, starts on the
    trace after the span's start plus 5 ms and ends before the span's end."""
    import torch

    from pilotguru_tpu_torch.utils import profiling

    torch.cuda._sleep(1000)
    trace = devtrace.DeviceTrace()
    timer = profiling.StageTimer("clock")
    trace.start()
    with profiling.recording(timer), profiling.stage("launch"):
        time.sleep(0.005)
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
    trace.stop()
    kernels = [(s, e) for name, s, e in trace.events
               if not name.startswith(devtrace.COPY_PREFIXES)]
    span = timer.spans[0]
    assert len(kernels) == 1
    start, end = kernels[0]
    assert span.start_ns + 5_000_000 <= start < end <= span.end_ns


def test_a_small_traced_training_run_is_put_down_to_the_loop(monkeypatch):
    """The train cell at batch 16, 2 nets and 64 examples on the CPU, traced
    through RecordingTrace, its device timeline replaced by a synthetic one
    (the middle half of each step call busy): the three idle shares sum to
    the idle share, and the tallies are the run's sizes."""

    def start(self):
        self.start_ns, self._prof = time.time_ns(), object()

    def stop(self):
        self.stop_ns, self._prof = time.time_ns(), None

    monkeypatch.setattr(devtrace.DeviceTrace, "start", start)
    monkeypatch.setattr(devtrace.DeviceTrace, "stop", stop)
    monkeypatch.setattr(pilotnet, "DeviceTrace", idle.RecordingTrace)
    name = "pilotnet-train-x3-b1024"
    cell, cfg, trf = small_training(name)
    harness.execute(name, 2147483659, 1.0, True, "cpu", time.time(), cell_spec=cell,
                    config_spec=cfg, traffic_spec=trf)
    trace = idle.RecordingTrace.last
    trace.events = [("kernel", s + (e - s) // 4, e - (e - s) // 4)
                    for _, s, e in trace.harness_spans]
    trace.events.append(("Memcpy HtoD (Pageable -> Device)", trace.start_ns,
                         trace.start_ns + 1000))
    trace.summary(devtrace.Spans(trace.harness_spans), "outside")
    got = idle.attribution(trace)
    idle_share = 100.0 * (1.0 - trace.summarized.busy_s / trace.summarized.window_s)
    shares = [got[f"train_idle_{k}_share"] for k in ("batch", "epoch_end", "other")]
    assert abs(sum(shares) - idle_share) < 1e-9 and min(shares) > 0
    epochs = 1  # ceil(1 s / the traffic's epoch seconds)
    h, w, c = cfg["input_shape"]
    row = h * w * c + 4 * (cfg["bias_input_dims"] + cfg["labels_per_example"])
    assert got["tallies"] == {
        "train.steps": 4 * epochs, "train.val_batches": 2 * epochs,
        "train.checkpoints": 2 * epochs + 2,
        "train.h2d_bytes": epochs * (64 * (row + 4 * 2) + 32 * row)}
    assert got["train_h2d_gb_per_s"] == got["tallies"]["train.h2d_bytes"] / 1e-6 / 1e9
    assert got["train_host_batch_ms_per_step"] == 1e3 * trace.timer.stages["train.batch"] / 4
    assert {gap[0].split("@")[0] for gap in got["idle_gaps"]} <= {
        s.name for s in trace.timer.spans} | {"no span"}


def test_profile_training_loads_no_jax():
    code = ("import sys, json, profile_training\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    tops = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "gpubench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "pilotguru_tpu"}
