"""Map checkpoints and two host utilities of the port against the JAX
package, on the CPU.

- vo/map_io.py: a map the JAX tracker builds on the synthetic scene of
  tests/test_utils_and_mapio.py (SyntheticScene(seed=6), 24 frames) loads
  into the port's tracker with every array equal (descriptors unpacked),
  and the port resumes tracking; a map the port's tracker builds on the
  same scene loads into the JAX tracker the same way; a version-1 file
  loads into both with the same defaults. The port's tracker takes the
  scene's features through process_features (it has no feature_fn), with
  zero levels and angles, as tests/test_torch_loopclosing.py feeds it.
- utils/kahan.py: the JAX tests' cases, and kahan_sum equal to the JAX
  one to the bit.
- utils/latest_value.py: the JAX tests' cases.
"""

import threading

import numpy as np
import pytest
import torch
from test_vo_tracking import SyntheticScene

from pilotguru_tpu.utils import kahan as jax_kahan
from pilotguru_tpu.vo import map_io as jax_map_io
from pilotguru_tpu.vo import tracking as jax_tracking
from pilotguru_tpu_torch.utils.kahan import KahanSum, kahan_sum
from pilotguru_tpu_torch.utils.latest_value import SynchronizedLatestValue
from pilotguru_tpu_torch.vo import map_io, tracking

torch.set_num_threads(1)

CONFIG = dict(total_budget=256, min_init_matches=40, min_init_inliers=30,
              min_track_inliers=15, match_search_radius=0.1)
BUILD = np.arange(0, 6.0, 0.25)  # the JAX test's frames
RESUME = np.arange(6.0, 8.0, 0.25)


def _jax_tracker(scene):
    return jax_tracking.MonocularTracker(
        jax_tracking.CameraModel(1.0, 1.0, 0.0, 0.0), jax_tracking.TrackerConfig(**CONFIG),
        feature_fn=lambda t: scene.frame_features(t))


def _port_tracker():
    return tracking.MonocularTracker(tracking.CameraModel(1.0, 1.0, 0.0, 0.0),
                                     tracking.TrackerConfig(**CONFIG), device="cpu",
                                     dtype=torch.float64)


def _port_feed(tracker, scene, times, first_id):
    zeros_level = np.zeros(scene.budget, np.int32)
    zeros_angle = np.zeros(scene.budget, np.float32)
    states = []
    for i, t in enumerate(times):
        kp, desc, valid = scene.frame_features(t)[:3]
        states.append(tracker.process_features(kp, desc, valid, first_id + i, int(t * 1e6),
                                               zeros_level, zeros_angle))
    return states


def _assert_same_map(got, want):
    """Every array the format holds, equal."""
    for name in ("points", "point_desc", "point_valid", "point_visible", "point_found",
                 "point_first_kf", "point_recent", "_pose", "_motion"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.state == want.state and got._next_kf_id == want._next_kf_id
    assert len(got.keyframes) == len(want.keyframes) >= 2
    for a, b in zip(got.keyframes, want.keyframes):
        for name in ("pose6", "kp_norm", "descriptors", "kp_valid", "map_point"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.num_inliers, a.kf_id) == (b.num_inliers, b.kf_id)
    assert len(got.trajectory) == len(want.trajectory)
    for a, b in zip(got.trajectory, want.trajectory):
        assert (a.frame_id, a.time_usec, a.is_lost, a.ref_kf_id) == (
            b.frame_id, b.time_usec, b.is_lost, b.ref_kf_id)
        np.testing.assert_array_equal(a.pose6, b.pose6)
        assert (a.rel6 is None) == (b.rel6 is None)
        if a.rel6 is not None:
            np.testing.assert_array_equal(a.rel6, b.rel6)


@pytest.fixture(scope="module")
def jax_map(tmp_path_factory):
    scene = SyntheticScene(seed=6)
    tracker = _jax_tracker(scene)
    for i, t in enumerate(BUILD):
        tracker.process_frame(t, i, int(t * 1e6))
    assert tracker.state == "OK"
    path = str(tmp_path_factory.mktemp("jax_map") / "map.npz")
    jax_map_io.save_tracker_map(tracker, path)
    return tracker, path


def test_jax_map_loads_into_the_port_and_resumes(jax_map):
    jax_tracker, path = jax_map
    restored = map_io.load_tracker_map(path, _port_tracker())
    _assert_same_map(restored, jax_tracker)
    states = _port_feed(restored, SyntheticScene(seed=6), RESUME, len(BUILD))
    assert states == ["OK"] * len(RESUME)
    assert len(restored.trajectory) == len(jax_tracker.trajectory) + len(RESUME)


def test_port_map_loads_into_jax_and_resumes(tmp_path):
    scene = SyntheticScene(seed=6)
    tracker = _port_tracker()
    assert _port_feed(tracker, scene, BUILD, 0)[-1] == "OK"
    path = str(tmp_path / "map.npz")
    pending = tracker._pending_ba
    map_io.save_tracker_map(tracker, path)
    assert tracker._pending_ba is pending is not None  # the save leaves it deferred
    tracker._apply_pending_ba()  # the file holds the map with it folded in
    restored = jax_tracking.MonocularTracker(
        jax_tracking.CameraModel(1.0, 1.0, 0.0, 0.0), jax_tracking.TrackerConfig(**CONFIG),
        feature_fn=lambda t: scene.frame_features(t))
    jax_map_io.load_tracker_map(path, restored)
    _assert_same_map(restored, tracker)
    for i, t in enumerate(RESUME):
        assert restored.process_frame(t, len(BUILD) + i, int(t * 1e6)) == "OK"
    # And back into the port: the same arrays again.
    _assert_same_map(map_io.load_tracker_map(path, _port_tracker()), tracker)


def test_a_save_leaves_the_run_as_it_is(tmp_path):
    """A tracker saved mid-run tracks on exactly as one never saved."""
    plain, saved = _port_tracker(), _port_tracker()
    _port_feed(plain, SyntheticScene(seed=6), np.concatenate([BUILD, RESUME]), 0)
    scene = SyntheticScene(seed=6)  # its feature noise draws advance frame by frame
    _port_feed(saved, scene, BUILD, 0)
    assert saved._pending_ba is not None
    map_io.save_tracker_map(saved, str(tmp_path / "map.npz"))
    _port_feed(saved, scene, RESUME, len(BUILD))
    for a, b in zip(saved.final_trajectory(), plain.final_trajectory()):
        np.testing.assert_array_equal(a.pose6, b.pose6)
    np.testing.assert_array_equal(saved.points, plain.points)


def test_version_one_file_loads_with_the_jax_defaults(jax_map, tmp_path):
    _, path = jax_map
    saved = dict(np.load(path))
    for key in ("point_visible", "point_found", "point_first_kf", "point_recent",
                "next_kf_id", "frame_ref_kf", "frame_rel", "frame_has_rel"):
        saved.pop(key)
    saved["format_version"] = np.asarray(1)
    v1 = str(tmp_path / "v1.npz")
    np.savez_compressed(v1, **saved)
    port = map_io.load_tracker_map(v1, _port_tracker())
    want = jax_map_io.load_tracker_map(v1, _jax_tracker(SyntheticScene(seed=6)))
    _assert_same_map(port, want)
    np.testing.assert_array_equal(port.point_visible, port.point_valid.astype(np.int32))
    assert port._next_kf_id == len(port.keyframes)
    assert all(fp.rel6 is None and fp.ref_kf_id == -1 for fp in port.trajectory)
    saved["format_version"] = np.asarray(3)
    np.savez_compressed(v1, **saved)
    with pytest.raises(ValueError, match="unsupported"):
        map_io.load_tracker_map(v1, _port_tracker())


# ---------------------------------------------------------------- kahan
def test_kahan_compensates_catastrophic_accumulation():
    acc = KahanSum()
    acc.add(1.0)
    for _ in range(1000):
        acc.add(1e-16 * 10000)
    assert acc.sum > 1.0
    assert kahan_sum(np.concatenate([[1e16], np.full(1000, 1.0), [-1e16]])) == 1000.0


@pytest.mark.parametrize("axis", [0, 1])
def test_kahan_sum_is_the_jax_packages_to_the_bit(axis):
    rng = np.random.default_rng(0)
    values = rng.normal(size=(500, 3)) * np.logspace(0, 12, 3)
    got = kahan_sum(values, axis=axis)
    np.testing.assert_array_equal(got, jax_kahan.kahan_sum(values, axis=axis))
    np.testing.assert_allclose(got, values.sum(axis=axis), rtol=1e-12)


# ---------------------------------------------------------- latest value
def test_latest_value_keeps_only_the_latest():
    cell = SynchronizedLatestValue()
    assert cell.latest() == (None, 0)
    cell.set("a")
    last_id = cell.set("b")
    assert cell.get_next(0, timeout=1.0) == ("b", last_id)


def test_latest_value_times_out_without_a_newer_value():
    cell = SynchronizedLatestValue()
    update_id = cell.set(42)
    assert cell.get_next(update_id, timeout=0.05) == (None, update_id)


def test_latest_value_producer_and_consumer_threads():
    cell = SynchronizedLatestValue()
    seen = []

    def consumer():
        update_id = 0
        while True:
            value, update_id = cell.get_next(update_id, timeout=2.0)
            if value is None:
                return
            seen.append(value)
            if value == 99:
                return

    thread = threading.Thread(target=consumer)
    thread.start()
    for i in range(100):
        cell.set(i)
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert seen[-1] == 99 and seen == sorted(seen)
