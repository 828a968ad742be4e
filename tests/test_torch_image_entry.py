"""The tracker's image entry (MonocularTracker.process_frame, feature_fn)
on the CPU, on the first frames of the golden video at the golden camera's
ORB settings:

- ``feature_fn=None`` extracts with the tracker's own extractor: a run of
  process_frame equals, to the bit, a run of the same frames through
  ``features`` and ``process_features``, and a uint8 frame gives the
  features of its float32 copy scaled to [0, 1] (the JAX tracker's
  ``_extract``);
- a ``feature_fn`` of three arrays means zero levels and angles;
- the segment loop feeds a frame without features through process_frame,
  once a frame, and its trajectory is the one the tracker's own features
  give. The JAX tracker with three-array features is held to the port's in
  tests/test_torch_map_maintenance.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.vo import pipeline
from pilotguru_tpu_torch.vo.camera import read_camera_settings
from pilotguru_tpu_torch.vo.tracking import OK, MonocularTracker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
FRAMES = 12


@pytest.fixture(scope="module")
def golden_start():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        frames = pipeline.video_frames(f"{INPUTS}/video.mp4")
        return [next(frames) for _ in range(FRAMES)]


def _tracker(feature_fn=None):
    camera, config = pipeline.camera_and_config(read_camera_settings(f"{INPUTS}/camera.yaml"),
                                                track_chunk_frames=0)
    return MonocularTracker(camera, config, feature_fn=feature_fn, device="cpu")


def _same_run(a, b):
    assert [len(a.keyframes), a.state] == [len(b.keyframes), b.state]
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.point_valid, b.point_valid)
    for x, y in zip(a.final_trajectory(), b.final_trajectory(), strict=True):
        assert x.frame_id == y.frame_id
        np.testing.assert_array_equal(x.pose6, y.pose6)


def test_process_frame_extracts_with_the_trackers_own_extractor(golden_start):
    entry, fed = _tracker(), _tracker()
    states = [entry.process_frame(f.gray, f.frame_id, f.time_usec) for f in golden_start]
    fed_states = []
    for f in golden_start:
        kp_norm, desc, valid, level, angle = fed.features(f.gray)
        fed_states.append(fed.process_features(kp_norm, desc, valid, f.frame_id, f.time_usec,
                                               level, angle))
    assert states == fed_states and states[-1] == OK
    _same_run(entry, fed)
    # The features it extracted last, as process_features took them.
    for got, want in zip(entry.frame_features, fed.features(golden_start[-1].gray)):
        np.testing.assert_array_equal(got, want)
    assert entry.feature_seconds > 0


def test_uint8_frames_scale_to_unit_floats(golden_start):
    gray = golden_start[0].gray
    assert gray.dtype == np.uint8
    tracker = _tracker()
    for got, want in zip(tracker.features(gray),
                         tracker.features(gray.astype(np.float32) / 255.0)):
        np.testing.assert_array_equal(got, want)


def test_three_arrays_mean_zero_levels_and_angles(golden_start):
    source = _tracker()
    feats = [source.features(f.gray) for f in golden_start]
    three = _tracker(feature_fn=lambda i: feats[i][:3])
    zeros = _tracker()
    for i, f in enumerate(golden_start):
        three.process_frame(i, f.frame_id, f.time_usec)
        k = feats[i][0].shape[0]
        zeros.process_features(*feats[i][:3], f.frame_id, f.time_usec,
                               np.zeros(k, np.int32), np.zeros(k, np.float32))
    assert three.frame_features[3].dtype == np.int32 and not three.frame_features[3].any()
    assert three.frame_features[4].dtype == np.float32 and not three.frame_features[4].any()
    _same_run(three, zeros)


def test_segment_loop_feeds_frames_without_features_to_process_frame(golden_start, tmp_path):
    calls = []
    trackers = []

    def make_tracker():
        tracker = _tracker()
        tracker._feature_fn = lambda gray: calls.append(gray) or tracker.features(gray)
        trackers.append(tracker)
        return tracker

    settings = read_camera_settings(f"{INPUTS}/camera.yaml")
    fresh = [pipeline.VideoFrame(f.gray, f.frame_id, f.time_usec) for f in golden_start]
    stages = {}
    _, consumed = pipeline.track_video_segments(
        fresh, settings, str(tmp_path / "entry"), feature_batch_size=0,
        make_tracker=make_tracker, device="cpu", stage_seconds=stages)
    assert (consumed, len(calls), len(trackers)) == (FRAMES, FRAMES, 1)
    assert trackers[0].state == OK
    assert stages["extract"] >= trackers[0].feature_seconds > 0
    # Each frame kept the features it was tracked with (the overlay reads them).
    assert all(f.features is not None for f in fresh)
    # The same frames carrying the tracker's own features track the same.
    carried = [dataclasses.replace(f, features=_tracker().features(f.gray))
               for f in golden_start]
    fed = []
    pipeline.track_video_segments(
        carried, settings, str(tmp_path / "carried"), feature_batch_size=0,
        make_tracker=lambda: fed.append(_tracker()) or fed[-1], device="cpu")
    _same_run(trackers[0], fed[0])
