"""Map maintenance of the port's tracker against the JAX package, on the CPU
in float64: the scenarios of tests/test_map_maintenance.py (map-point
culling, slot recycling under arena pressure, keyframe culling, duplicate
fusion) with their assertions, the port's tracker taking the synthetic
scene's features through ``feature_fn`` (three arrays: no levels, no
angles); then one scene against the JAX tracker: a map the JAX tracker
built, loaded into a fresh tracker of each package, tracked on over the
same frames through ``process_frame``.
"""

import numpy as np
import pytest
import torch
from test_vo_tracking import SyntheticScene

from pilotguru_tpu.vo import map_io as jax_map_io
from pilotguru_tpu.vo import tracking as jax_tracking
from pilotguru_tpu_torch.vo import map_io
from pilotguru_tpu_torch.vo.tracking import (
    LOST,
    OK,
    CameraModel,
    Keyframe,
    MonocularTracker,
    TrackerConfig,
)

torch.set_num_threads(1)

BASE = dict(total_budget=256, min_init_matches=40, min_init_inliers=30,
            min_track_inliers=15, match_search_radius=0.1, enable_loop_closing=False)


def _tracker(config, feature_fn=None):
    return MonocularTracker(CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0), config,
                            feature_fn=feature_fn, device="cpu", dtype=torch.float64)


def run_tracker(config, scene, duration=12.0, step=0.25, feature_fn=None):
    tracker = _tracker(config, feature_fn or (lambda t: scene.frame_features(t)))
    states = [tracker.process_frame(t, i, int(t * 1e6))
              for i, t in enumerate(np.arange(0, duration, step))]
    return tracker, states


def _valid_count_is_accounted(tracker) -> bool:
    """Every created point is valid, or counted culled, fused or recycled."""
    s = tracker.stats
    return int(tracker.point_valid.sum()) == (
        s["points_created"] - s["points_culled"] - s["points_fused"] - s["points_recycled"])


@pytest.fixture(scope="module")
def base_run():
    return run_tracker(TrackerConfig(**BASE), SyntheticScene())


def test_unfound_points_get_culled(base_run):
    tracker, states = base_run
    assert states[-1] == OK
    assert tracker.stats["points_culled"] > 0
    valid = np.nonzero(tracker.point_valid & ~tracker.point_recent)[0]
    assert valid.size > 50


def test_culled_slots_are_reused(base_run):
    tracker, _ = base_run
    late = tracker.point_first_kf[tracker.point_valid] >= 3
    assert late.any()


def test_no_dangling_keyframe_references(base_run):
    tracker, _ = base_run
    for kf in tracker.keyframes:
        refs = kf.map_point[kf.map_point >= 0]
        assert tracker.point_valid[refs].all(), "reference to culled point"


def test_saturated_arena_recycles_instead_of_dying():
    config = TrackerConfig(max_map_points=300, **BASE)
    tracker, states = run_tracker(config, SyntheticScene(), duration=16.0)
    assert states[-1] == OK, f"tracking died: {states[-5:]}"
    assert tracker.stats["points_recycled"] > 0
    # Nothing silently dropped: every point created is valid or counted.
    assert _valid_count_is_accounted(tracker)
    assert 100 < tracker.point_valid.sum() <= 300


@pytest.fixture(scope="module")
def lingering_run():
    """Half-speed motion with a keyframe every 2 frames (the JAX test's)."""
    scene = SyntheticScene()
    return run_tracker(TrackerConfig(keyframe_max_gap=2, **BASE), scene, duration=20.0,
                       feature_fn=lambda t: scene.frame_features(t * 0.5))


def test_redundant_keyframes_culled_when_camera_lingers(lingering_run):
    tracker, states = lingering_run
    assert LOST not in states
    assert tracker.stats["keyframes_culled"] > 0


def test_trajectory_survives_keyframe_culling(lingering_run):
    tracker, _ = lingering_run
    assert tracker.stats["keyframes_culled"] > 0
    final = tracker.final_trajectory()
    assert len(final) == len(tracker.trajectory)
    live_ids = {kf.kf_id for kf in tracker.keyframes}
    for fp in tracker.trajectory:
        assert fp.ref_kf_id in live_ids or fp.ref_kf_id == -1, (
            "frame anchored to a culled keyframe was not re-anchored")
    for fp_final, fp_raw in zip(final, tracker.trajectory):
        assert np.all(np.isfinite(fp_final.pose6))
        assert np.linalg.norm(fp_final.pose6 - fp_raw.pose6) < 0.5


def _tracker_with_duplicate():
    """The JAX test's hand-built map: two twin points and one other, seen
    by two keyframes, the second keyframe's observation on the twin."""
    rng = np.random.default_rng(0)
    tracker = _tracker(TrackerConfig(max_map_points=64, **BASE))
    k = 8
    desc_dup = rng.integers(0, 2, size=256).astype(np.uint8)
    desc_other = rng.integers(0, 2, size=256).astype(np.uint8)
    p = np.array([0.1, -0.05, 4.0])
    other = np.array([-0.3, 0.2, 5.0])
    tracker.points[:3] = [p, p + 1e-4, other]
    tracker.point_desc[:3] = [desc_dup, desc_dup, desc_other]
    tracker.point_valid[:3] = True
    tracker.point_visible[:3] = 4
    tracker.point_found[:3] = 4

    def kf(map_refs):
        kp = np.zeros((k, 2))
        desc = np.zeros((k, 256), np.uint8)
        valid = np.zeros(k, bool)
        kp[0], desc[0], valid[0] = p[:2] / p[2], desc_dup, True
        kp[1], desc[1], valid[1] = other[:2] / other[2], desc_other, True
        mp = np.full(k, -1, np.int32)
        for row, pid in map_refs.items():
            mp[row] = pid
        return Keyframe(np.zeros(6), kp, desc, valid, mp, 2, kf_id=tracker._next_kf_id,
                        kp_level=np.zeros(k, np.int32), kp_angle=np.zeros(k, np.float32))

    kf_a = kf({0: 0, 1: 2})
    tracker._next_kf_id += 1
    kf_b = kf({0: 1})
    tracker._next_kf_id += 1
    tracker.keyframes = [kf_a, kf_b]
    tracker._refresh_local_points()
    return tracker, kf_a, kf_b


def _fuse(tracker, kf):
    tracker._fuse_duplicates(kf, tracker._dispatch_fuse(kf))


def test_duplicate_points_get_fused():
    tracker, kf_a, kf_b = _tracker_with_duplicate()
    _fuse(tracker, kf_b)
    assert tracker.stats["points_fused"] == 1
    assert tracker.point_valid[:2].sum() == 1
    survivor = int(np.nonzero(tracker.point_valid[:2])[0][0])
    assert kf_a.map_point[0] == survivor
    assert kf_b.map_point[0] == survivor


def test_match_onto_free_keypoint_adds_observation():
    tracker, _, kf_b = _tracker_with_duplicate()
    assert kf_b.map_point[1] == -1
    _fuse(tracker, kf_b)
    assert kf_b.map_point[1] == 2


def test_fusion_keeps_references_consistent():
    tracker, _, kf_b = _tracker_with_duplicate()
    _fuse(tracker, kf_b)
    for kf in tracker.keyframes:
        refs = kf.map_point[kf.map_point >= 0]
        assert tracker.point_valid[refs].all()


# One scene against the JAX tracker: the JAX tracker maps the first 24
# frames; its map file loads into a fresh tracker of each package, and both
# track 16 more frames (culling, creation and keyframe culling at every
# other frame) through process_frame, fed the same three arrays a frame.
# Measured: every state, count and map array equal, the points within
# 5.3e-11 and the poses within 1.5e-10 (float64; the two packages' LM and
# BA sum in other orders).
POSE_TOL = 1e-8


def test_tracks_on_like_the_jax_tracker(tmp_path):
    scene = SyntheticScene(seed=6)
    config = dict(BASE, keyframe_max_gap=2)
    times = np.arange(0, 10.0, 0.25)
    frames = [scene.frame_features(t) for t in times]
    build, resume = range(24), range(24, len(times))
    jax_config = jax_tracking.TrackerConfig(**config)
    mapper = jax_tracking.MonocularTracker(
        jax_tracking.CameraModel(1.0, 1.0, 0.0, 0.0), jax_config,
        feature_fn=lambda i: frames[i])
    for i in build:
        mapper.process_frame(i, i, int(times[i] * 1e6))
    assert mapper.state == OK
    path = str(tmp_path / "map.npz")
    jax_map_io.save_tracker_map(mapper, path)

    want = jax_tracking.MonocularTracker(
        jax_tracking.CameraModel(1.0, 1.0, 0.0, 0.0), jax_config,
        feature_fn=lambda i: frames[i])
    jax_map_io.load_tracker_map(path, want)
    got = map_io.load_tracker_map(path, _tracker(TrackerConfig(**config),
                                                 feature_fn=lambda i: frames[i]))
    want_states = [want.process_frame(i, i, int(times[i] * 1e6)) for i in resume]
    got_states = [got.process_frame(i, i, int(times[i] * 1e6)) for i in resume]
    assert got_states == want_states == [OK] * len(resume)
    for name in ("points_created", "points_culled", "points_fused", "points_recycled",
                 "keyframes_culled"):
        assert got.stats[name] == want.stats[name], name
    assert want.stats["points_culled"] > 0 and want.stats["keyframes_culled"] > 0
    want._flush_point_desc()  # the JAX tracker writes created points' descriptors late
    valid = want.point_valid
    np.testing.assert_array_equal(got.point_valid, valid)
    for name in ("point_desc", "point_visible", "point_found", "point_first_kf",
                 "point_recent"):
        np.testing.assert_array_equal(getattr(got, name)[valid], getattr(want, name)[valid],
                                      err_msg=name)
    np.testing.assert_allclose(got.points[valid], want.points[valid], atol=POSE_TOL, rtol=0)
    assert [kf.kf_id for kf in got.keyframes] == [kf.kf_id for kf in want.keyframes]
    for a, b in zip(got.final_trajectory(), want.final_trajectory()):
        assert (a.frame_id, a.ref_kf_id) == (b.frame_id, b.ref_kf_id)
        np.testing.assert_allclose(a.pose6, b.pose6, atol=POSE_TOL, rtol=0)
