"""The port's profiler hook (utils/profiling.py: maybe_profiler_trace, the
counterpart of the JAX package's maybe_jax_profiler_trace) on the CPU:
with PILOTGURU_TPU_PROFILE_DIR set it writes a torch.profiler Chrome trace
of the region under <dir>/<region>/, holding the region's operations;
unset it writes nothing. The fit_motion CLI wraps its run in it, as the
JAX CLI does, and its outputs are the same with the trace as without."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.cli import fit_motion
from pilotguru_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIDE = os.path.join(REPO, "tests", "golden", "inputs", "ride")


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_written_when_the_variable_is_set(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    with profiling.maybe_profiler_trace("region"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = tmp_path / "region" / "trace.json"
    assert path.is_file()
    names = {e.get("name") for e in _trace_events(path)}
    assert any(name and "matmul" in name for name in names)


def test_nothing_written_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_profiler_trace("region"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_fit_motion_cli_writes_its_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    outputs = {}
    for traced in (False, True):
        out = tmp_path / ("traced" if traced else "plain")
        out.mkdir()
        if traced:
            monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "profile"))
        else:
            monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
        assert fit_motion.main([
            f"--rotations_json={RIDE}/rotations.json",
            f"--accelerations_json={RIDE}/accelerations.json",
            f"--locations_json={RIDE}/locations.json", "--locations_batch_size=20",
            f"--velocities_out_json={out}/v.json", f"--steering_out_json={out}/s.json",
            f"--forward_axis_out_json={out}/f.json"]) == 0
        outputs[traced] = {n: (out / n).read_bytes() for n in ("v.json", "s.json", "f.json")}
    assert outputs[True] == outputs[False]
    trace = tmp_path / "profile" / "fit_motion" / "trace.json"
    assert trace.is_file() and len(_trace_events(trace)) > 100


def _nest(timer):
    """outer > (first > inner, second), through the timer's own stage()."""
    with timer.stage("outer", epoch=3):
        with timer.stage("first"):
            with timer.stage("inner"):
                torch.ones(8).sum()
        with timer.stage("second"):
            torch.ones(8).sum()


def test_spans_nest_with_their_parents_and_self_time_leaves_out_children():
    timer = profiling.StageTimer("nest")
    _nest(timer)
    assert [(s.name, s.parent) for s in timer.spans] == [
        ("outer", -1), ("first", 0), ("inner", 1), ("second", 0)]
    assert timer.spans[0].attrs == {"epoch": 3} and timer.spans[1].attrs is None
    for s in timer.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = timer.spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns

    def length(i):
        return timer.spans[i].end_ns - timer.spans[i].start_ns

    assert timer.self_ns() == [length(0) - length(1) - length(3), length(1) - length(2),
                               length(2), length(3)]
    # The stage sums are the spans' lengths, in seconds.
    assert timer.as_dict()["outer"] == length(0) / 1e9
    assert timer.counts == {"inner": 1, "first": 1, "second": 1, "outer": 1}


def test_report_sums_each_stage_in_the_order_first_entered():
    timer = profiling.StageTimer("sums")
    _nest(timer)
    _nest(timer)
    assert timer.order == ["inner", "first", "second", "outer"]
    assert timer.counts == dict.fromkeys(timer.order, 2) and len(timer.spans) == 8
    assert list(timer.as_dict()) == timer.order
    assert timer.total_seconds() == sum(timer.as_dict().values()) > 0
    lines = timer.report().splitlines()
    assert lines[0] == "[sums] stage wall times:" and lines[-1].split()[0] == "total"
    assert [line.split()[0] for line in lines[1:-1]] == timer.order
    assert all(line.endswith("x2") for line in lines[1:-1])


def test_tallies_add_up():
    timer = profiling.StageTimer("counts")
    timer.count("steps")
    timer.count("steps")
    timer.count("bytes", 40_583_168)
    timer.count("bytes", 12)
    timer.count("none", 0)
    assert timer.tallies == {"steps": 2, "bytes": 40_583_180, "none": 0}


def test_module_stage_and_count_do_nothing_without_a_recorder():
    first, second = profiling.stage("a"), profiling.stage("b", epoch=1)
    assert first is second  # one shared context, no timer made
    with first:
        profiling.count("steps")
    timer = profiling.StageTimer("ambient")
    with profiling.recording(timer) as installed:
        assert installed is timer
        with profiling.stage("train.epoch", epoch=0):
            profiling.count("train.steps")
            profiling.count("train.h2d_bytes", 7)
            with profiling.stage("train.step"):
                pass
        inner = profiling.StageTimer("inner")
        with profiling.recording(inner):
            profiling.count("train.steps", 5)
        profiling.count("train.steps")
    assert profiling.stage("c") is first
    profiling.count("train.steps")
    assert [(s.name, s.parent, s.attrs) for s in timer.spans] == [
        ("train.epoch", -1, {"epoch": 0}), ("train.step", 0, None)]
    assert timer.tallies == {"train.steps": 2, "train.h2d_bytes": 7}
    assert inner.tallies == {"train.steps": 5}


def test_a_profiler_event_lies_inside_the_program_span_around_it():
    """The spans' clock is torch.profiler's: an operation recorded inside a
    program span starts after the span's start and ends before its end."""
    timer = profiling.StageTimer("clock")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording(timer), profiling.stage("outer"):
            with torch.profiler.record_function("marked_region"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "marked_region"]
    assert len(events) == 1
    start, end = events[0].start_ns(), events[0].start_ns() + events[0].duration_ns()
    span = timer.spans[0]
    assert span.start_ns <= start < end <= span.end_ns


TOY_SHAPE = (40, 40, 3)


def _tiny_run(out_dir, batch_use_prob, timer=None):
    """Two ToyConvNet nets, 3 epochs of 22 examples at batch 8 (batches of
    8, 8 and 6), 10 validation examples; returns the log's lines."""
    from pilotguru_tpu_torch.ml import augmentation, models, training, weighting

    rng = np.random.default_rng(3)
    h, w, c = TOY_SHAPE

    def data(n):
        return {"frame_img": rng.integers(0, 256, (n, h, w, c), dtype=np.uint8),
                "steering": rng.normal(size=(n,)).astype(np.float32)}

    train, val = data(22), data(10)
    options = {"net_name": "toy", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [], TOY_SHAPE)
    tx = training.make_optimizer("sgd", 0.05)
    state = training.init_ensemble(model, {"frame_img": np.zeros((1,) + TOY_SHAPE, np.float32)},
                                   2, tx, seed=1, device="cpu")
    weighters = [weighting.make_sample_weighter({"name": "uniform"}, np.abs(train["steering"]))
                 for _ in range(2)]
    settings = training.TrainSettings(
        epochs=3, batch_size=8, learning_rate=0.05, optimizer="sgd",
        batch_use_prob=batch_use_prob, augment=augmentation.AugmentSettings(target_width=w))
    log_path = os.path.join(out_dir, "train_log.jsonl")
    with (profiling.recording(timer) if timer else contextlib.nullcontext()):
        training.train_models(model, state, tx, train, val, input_names=["frame_img"],
                              label_name="steering", weighters=weighters, settings=settings,
                              out_dir=out_dir, print_log=False, log_path=log_path)
    with open(log_path) as f:
        return [json.loads(line) for line in f]


TIMING_FIELDS = ("epoch_duration_sec", "examples_per_sec")


@pytest.mark.parametrize("batch_use_prob", [1.0, 0.4])
def test_recorded_training_writes_the_same_and_counts_its_work(tmp_path, batch_use_prob):
    plain, recorded = tmp_path / "plain", tmp_path / "recorded"
    timer = profiling.StageTimer("train")
    logs = [_tiny_run(str(plain), batch_use_prob),
            _tiny_run(str(recorded), batch_use_prob, timer)]
    assert [[{k: v for k, v in e.items() if k not in TIMING_FIELDS} for e in log]
            for log in logs][0] == [
        {k: v for k, v in e.items() if k not in TIMING_FIELDS} for e in logs[1]]
    files = sorted(p.name for p in plain.iterdir())
    assert files == sorted(p.name for p in recorded.iterdir())
    assert any(name.endswith(".msgpack") for name in files)
    for name in files:
        if name.endswith(".msgpack"):
            assert (plain / name).read_bytes() == (recorded / name).read_bytes(), name

    h, w, c = TOY_SHAPE
    epochs, sizes, val_sizes, nets = 3, (8, 8, 6), (8, 2), 2
    tallies = timer.tallies
    assert tallies["train.steps"] + tallies.get("train.skipped_batches", 0) == epochs * 3
    if batch_use_prob == 1.0:
        assert tallies["train.steps"] == epochs * 3
    else:
        assert tallies["train.skipped_batches"] > 0
    assert tallies["train.val_batches"] == epochs * len(val_sizes)
    # Frames (uint8) and labels (float32) of every batch, the weights
    # [nets, b] (float32) of every training batch.
    train_bytes = sum(b * (h * w * c + 4 + 4 * nets) for b in sizes)
    val_bytes = sum(b * (h * w * c + 4) for b in val_sizes)
    assert tallies["train.h2d_bytes"] == epochs * (train_bytes + val_bytes)
    best = sum(1 for name in files if "best" in name)
    assert tallies["train.checkpoints"] >= nets + best

    names = [s.name for s in timer.spans]
    assert names.count("train.epoch") == epochs
    assert names.count("train.batch") == epochs * 3
    assert names.count("train.step") == tallies["train.steps"]
    by_name = {}
    for s in timer.spans:
        by_name.setdefault(s.name, set()).add(
            timer.spans[s.parent].name if s.parent >= 0 else None)
    assert by_name == {
        "train.epoch": {None}, "train.batch": {"train.epoch"}, "train.step": {"train.epoch"},
        "train.epoch_end": {"train.epoch"}, "train.pull": {"train.epoch_end"},
        "train.validate": {"train.epoch_end"}, "train.log": {"train.epoch_end"},
        "train.checkpoint": {"train.epoch_end", None}}
    assert [s.attrs for s in timer.spans if s.name == "train.epoch"] == [
        {"epoch": e} for e in range(epochs)]


def test_recorded_search_group_writes_the_same_and_spans_its_setup(tmp_path):
    from pilotguru_tpu_torch.cli import hyperparams_search

    rng = np.random.default_rng(4)
    h, w, c = TOY_SHAPE
    data = [{"frame_img": rng.integers(0, 256, (n, h, w, c), dtype=np.uint8),
             "steering": rng.normal(size=(n,)).astype(np.float32)} for n in (16, 8)]
    base = {"input_names": ["frame_img"], "label_names": ["steering"], "net_name": "toy",
            "target_height": h, "target_width": w, "linear_bias_options": [],
            "optimizer": "sgd", "batch_size": 8}
    folds = [dict(base, learning_rate=0.03, settings_id="a"),
             dict(base, learning_rate=0.01, settings_id="b")]
    timer = profiling.StageTimer("search")
    outputs = []
    for tag, recorder in (("plain", None), ("recorded", timer)):
        with (profiling.recording(recorder) if recorder else contextlib.nullcontext()):
            hyperparams_search.run_training_group(
                folds, *data, epochs=2, num_nets=1, batch_use_prob=1.0,
                out_root=str(tmp_path / tag / "out"), log_root=str(tmp_path / tag / "log"),
                device="cpu")
        files = {}
        for path in sorted((tmp_path / tag).rglob("*")):
            if path.is_file():
                key = str(path.relative_to(tmp_path / tag))
                if key.endswith(".jsonl"):
                    files[key] = [{k: v for k, v in json.loads(line).items()
                                   if k not in TIMING_FIELDS}
                                  for line in path.read_text().splitlines()]
                else:
                    files[key] = path.read_bytes()
        outputs.append(files)
    assert outputs[0] == outputs[1] and len(outputs[0]) == 2 * 3  # best, last, log a fold
    top = [s.name for s in timer.spans if s.parent == -1]
    assert top == ["search.setup", "train.epoch", "train.epoch", "train.checkpoint",
                   "search.fold_logs"]
    assert timer.tallies["train.steps"] == 2 * 2 and timer.tallies["train.val_batches"] == 2

