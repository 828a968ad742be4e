"""The training loop's host-to-device staging (ml/staging.py).

On the CPU the loop stages through ``PageableStaging``, as it always has:
no worker thread, no pinned buffer, no copy stream, and none of the
pipeline's tallies. ``PinnedStaging``'s host side (its plan, its ring of
buffers, its worker's gathers) is held to ``PageableStaging`` on the CPU
with the stream and pinned-memory calls stood in. Marked ``cuda``: on the
card the pipeline trains exactly as the pageable form does, and no stream
sync, device sync or blocking copy happens inside a ``train.batch`` or
``train.step`` span after an epoch's first step.

This file imports nothing of JAX, so on the card it runs without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_staging.py -m cuda
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from gpubench.metrics import train_h2d_pinned_share
from pilotguru_tpu_torch.ml import augmentation, models, staging, training, weighting
from pilotguru_tpu_torch.utils import profiling

TIMING_FIELDS = ("epoch_duration_sec", "examples_per_sec")
WEIGHTERS = {
    "uniform": {"name": "uniform"},
    "label_l1": {"name": "label_l1", "label_l1_weight_scale": 2.0},
    "exp_recent_loss": {"name": "exp_recent_loss", "recent_loss_lr": 0.5,
                        "recent_loss_exp_scale": 0.5, "raw_weight_clip": 4.0},
}
TOY = (40, 40, 3)
UNIFORM = ("uniform",) * 3
MIXED = ("uniform", "label_l1", "exp_recent_loss")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _train(out_dir, device, *, net, shape, batch_use_prob, weighter_names, devices=None,
           timer=None, sizes=(22, 10), batch=8, epochs=3):
    """One ``train_models`` call of len(weighter_names) nets from seed 5's
    data (uint8 frames, the forward axis, one steering label); returns the
    log's lines without their timings and every checkpoint file's bytes."""
    rng = np.random.default_rng(5)
    h, w, c = shape

    def data(n):
        return {"frame_img": rng.integers(0, 256, (n, h, w, c), dtype=np.uint8),
                "forward_axis": rng.normal(size=(n, 3)).astype(np.float32),
                "steering": rng.normal(0, 0.5, size=(n,)).astype(np.float32)}

    train, val = data(sizes[0]), data(sizes[1])
    options = {"net_name": net, "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                shape)
    tx = training.make_optimizer("sgd", 0.01)
    nets = len(weighter_names)
    state = training.init_ensemble(model, {}, nets, tx, seed=1, device=device)
    weighters = [weighting.make_sample_weighter(WEIGHTERS[name], np.abs(train["steering"]))
                 for name in weighter_names]
    settings = training.TrainSettings(
        epochs=epochs, batch_size=batch, learning_rate=0.01, optimizer="sgd",
        batch_use_prob=batch_use_prob, plateau_patience_epochs=1,
        augment=augmentation.AugmentSettings(target_width=w))
    log_path = os.path.join(out_dir, "train_log.jsonl")
    with (profiling.recording(timer) if timer else contextlib.nullcontext()):
        training.train_models(model, state, tx, train, val,
                              input_names=["frame_img", "forward_axis"], label_name="steering",
                              weighters=weighters, settings=settings, out_dir=out_dir,
                              print_log=False, log_path=log_path, devices=devices)
    with open(log_path) as f:
        log = [{k: v for k, v in json.loads(line).items() if k not in TIMING_FIELDS}
               for line in f]
    files = {name: open(os.path.join(out_dir, name), "rb").read()
             for name in sorted(os.listdir(out_dir)) if name.endswith(".msgpack")}
    return log, files


def _refuse(*args, **kwargs):
    raise AssertionError("the CPU loop reached the pinned pipeline")


@pytest.mark.parametrize("batch_use_prob", [1.0, 0.4])
def test_the_cpu_loop_stages_without_the_pipeline(tmp_path, monkeypatch, batch_use_prob):
    monkeypatch.setattr(staging, "PinnedStaging", _refuse)
    monkeypatch.setattr(staging, "ThreadPoolExecutor", _refuse)
    monkeypatch.setattr(staging, "_pinned", _refuse)
    timer = profiling.StageTimer("train")
    _train(str(tmp_path), "cpu", net="toy", shape=TOY, batch_use_prob=batch_use_prob,
           weighter_names=MIXED, timer=timer)
    want = {"train.steps", "train.val_batches", "train.checkpoints", "train.h2d_bytes",
            "train.per_net_forwards"}
    if batch_use_prob < 1.0:
        want.add("train.skipped_batches")
    assert set(timer.tallies) == want
    h, w, c = TOY
    epochs, nets, train_sizes, val_sizes = 3, 3, (8, 8, 6), (8, 2)
    assert timer.tallies["train.h2d_bytes"] == epochs * (
        sum(b * (h * w * c + 4 * 3 + 4 + 4 * nets) for b in train_sizes)
        + sum(b * (h * w * c + 4 * 3 + 4) for b in val_sizes))
    assert [s.name for s in timer.spans].count("train.batch") == epochs * len(train_sizes)


class _Event:
    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass


class _Stream:
    def __init__(self, device=None):
        pass

    def wait_event(self, event):
        pass


@pytest.fixture
def stand_in_streams(monkeypatch):
    """``PinnedStaging`` on CPU devices: pageable buffers for pinned ones,
    and streams and events that do nothing (a CPU copy is done when it
    returns)."""
    monkeypatch.setattr(staging, "_pinned", lambda shape, dtype: torch.empty(shape, dtype=dtype))
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, stream: None)


@pytest.mark.parametrize("batch_use_prob, weighter_names, blocks", [
    (1.0, UNIFORM, 1), (0.4, UNIFORM, 1), (1.0, MIXED, 1), (0.4, MIXED, 2)])
def test_the_pipeline_sends_what_the_pageable_form_sends(tmp_path, monkeypatch,
                                                         stand_in_streams, batch_use_prob,
                                                         weighter_names, blocks):
    """The pipeline's host side on the CPU: the same losses, lr_scale and
    checkpoints as the pageable form, every byte from the ring's buffers,
    and the pageable form's tallies but for the batches it leaves out."""
    devices = ["cpu"] * blocks if blocks > 1 else None
    kwargs = dict(net="toy", shape=TOY, batch_use_prob=batch_use_prob,
                  weighter_names=weighter_names, devices=devices, sizes=(45, 21), epochs=4)
    timers = {tag: profiling.StageTimer(tag) for tag in ("pageable", "pinned")}
    plain = _train(str(tmp_path / "pageable"), "cpu", timer=timers["pageable"], **kwargs)
    monkeypatch.setattr(staging, "open_staging", lambda names, label, blocks, batch_size:
                        staging.PinnedStaging(names, label, blocks, batch_size))
    piped = _train(str(tmp_path / "pinned"), "cpu", timer=timers["pinned"], **kwargs)
    assert piped == plain
    a, b = timers["pageable"].tallies, timers["pinned"].tallies
    assert b["train.h2d_pinned_bytes"] == b["train.h2d_bytes"] > 0
    for name in ("train.steps", "train.val_batches", "train.checkpoints",
                 "train.skipped_batches"):
        assert a.get(name) == b.get(name), name
    spans = {tag: [s.name for s in t.spans].count("train.batch") for tag, t in timers.items()}
    assert spans["pinned"] == spans["pageable"] - a.get("train.skipped_batches", 0)


def test_the_ring_waits_for_a_buffer_whose_copies_have_not_finished(monkeypatch,
                                                                    stand_in_streams):
    """A buffer is written again only after its copies' events: an event
    not yet done is waited for, and tallied."""
    waited = []

    class Pending(_Event):
        def query(self):
            return False

        def synchronize(self):
            waited.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Pending)
    data = {"x": np.arange(40, dtype=np.float32).reshape(20, 2),
            "y": np.arange(20, dtype=np.float32)}
    timer = profiling.StageTimer("ring")
    with profiling.recording(timer), staging.PinnedStaging(["x"], "y", [(0, 2, "cpu")], 4) as s:
        batches = [np.array([3, 1, 4, 1]), np.array([5, 9]), np.array([2, 6, 5]),
                   np.array([3, 5, 8, 9]), np.array([7])]
        s.plan(data, batches)
        got = [s.send() for _ in batches]
    for idx, staged in zip(batches, got):
        inputs, labels = staged.batch["cpu"]
        np.testing.assert_array_equal(inputs["x"].numpy(), data["x"][idx])
        np.testing.assert_array_equal(labels.numpy(), data["y"][idx][:, None])
    # Batches 3 and 4 reuse the buffers of batches 0 and 1.
    assert len(waited) == 2
    assert timer.tallies["train.staging_waits"] >= 2


def test_train_h2d_pinned_share_reads_the_tallies():
    def layer(**tallies):
        return {"train": {"steps": 4, "tallies": tallies}}

    read = train_h2d_pinned_share.read
    assert read(layer(**{"train.h2d_bytes": 400, "train.h2d_pinned_bytes": 400})) == 100.0
    assert read(layer(**{"train.h2d_bytes": 400, "train.h2d_pinned_bytes": 100})) == 25.0
    assert read(layer(**{"train.h2d_bytes": 400, "train.h2d_pinned_bytes": 0})) == 0.0
    assert read(layer(**{"train.h2d_bytes": 400})) is None
    assert read(layer(**{"train.h2d_bytes": 0, "train.h2d_pinned_bytes": 0})) is None
    assert read(layer()) is None
    assert read({"train": {"steps": 4}}) is None
    assert read({}) is None


# ------------------------------------------------------------- on the card
CARD = dict(net="nvidia", shape=(66, 200, 3), sizes=(300, 100), batch=64, epochs=3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_use_prob, weighter_names, blocks", [
    (1.0, UNIFORM, 1), (0.4, UNIFORM, 1), (1.0, MIXED, 1), (0.4, MIXED, 2)])
def test_the_card_pipeline_trains_as_the_pageable_form(cuda, tmp_path, monkeypatch,
                                                       batch_use_prob, weighter_names, blocks):
    """A PilotNet x3 run through the pipeline against the same run with the
    pageable form in its place: per-epoch train and validation losses,
    lr_scale and every checkpoint file equal to the bit."""
    devices = [torch.device("cuda", 0)] * blocks if blocks > 1 else None
    kwargs = dict(CARD, batch_use_prob=batch_use_prob, weighter_names=weighter_names,
                  devices=devices)
    timer = profiling.StageTimer("pinned")
    piped = _train(str(tmp_path / "pinned"), cuda, timer=timer, **kwargs)
    assert timer.tallies["train.h2d_pinned_bytes"] == timer.tallies["train.h2d_bytes"]
    monkeypatch.setattr(staging, "PinnedStaging",
                        lambda names, label, blocks, batch_size:
                        staging.PageableStaging(names, label, blocks))
    plain = _train(str(tmp_path / "pageable"), cuda, **kwargs)
    assert piped == plain


@pytest.mark.cuda
def test_no_sync_inside_the_batch_and_step_spans_on_the_card(cuda, tmp_path, monkeypatch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` inside every
    ``train.batch`` and ``train.step`` span after an epoch's first step, a
    stream sync, a device sync or a blocking copy raises; every byte leaves
    from a pinned buffer."""
    real_stage = profiling.stage
    seen = {"steps": 0, "guarded": 0}

    @contextlib.contextmanager
    def stage(name, **attrs):
        with real_stage(name, **attrs):
            if name == "train.epoch":
                seen["steps"] = 0
            guarded = name in ("train.batch", "train.step") and seen["steps"] > 0
            if guarded:
                seen["guarded"] += 1
                torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                if guarded:
                    torch.cuda.set_sync_debug_mode(0)
                if name == "train.step":
                    seen["steps"] += 1

    monkeypatch.setattr(profiling, "stage", stage)
    timer = profiling.StageTimer("train")
    _train(str(tmp_path), cuda, timer=timer, batch_use_prob=1.0, weighter_names=MIXED, **CARD)
    assert seen["guarded"] == CARD["epochs"] * (2 * 5 - 3)  # 5 batches an epoch
    assert timer.tallies["train.h2d_pinned_bytes"] == timer.tallies["train.h2d_bytes"]
