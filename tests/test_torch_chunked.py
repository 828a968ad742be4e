"""Chunked tracking in the port (vo/tracking.py: fused_track_chunk,
MonocularTracker.process_chunk) against the JAX package, on the CPU in
float64, on the synthetic feature streams of tests/test_vo_tracking.py
(a landmark cloud with stable descriptors, decoys and bit noise).

- fused_track_chunk on one map, one pose and C = 16 frames, one of them
  under min_track_inliers so the carry freezes: inlier counts, match
  indices and masks equal to the JAX function's; poses within 1e-5, the
  float32 rounding of the packed result.
- The port's own paths, as tests/test_vo_tracking.py::TestChunkedTracking
  holds the JAX package's: chunked with chunk_through_keyframes=False
  equals per-frame (states and keyframe ids equal, poses within 1e-4; in
  float32, the card's geometry dtype, equal to the bit);
  through keyframes the ride stays tracked with median drift under 0.05; a
  mid-chunk blackout surfaces LOST.
- Through keyframes against the JAX tracker on the same feature stream with
  the reference's two-view draws replayed: states, keyframe ids and frames
  consumed a chunk equal; poses within 1e-8 (measured 1.2e-10).
- The reference's synthetic loop ride through chunks in float32: the loop
  closes from a keyframe inserted mid-chunk.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_loopclosing import LoopScene
from test_torch_slice_replay import _replay
from test_vo_tracking import SyntheticScene

from pilotguru_tpu.vo import matching as jmatching
from pilotguru_tpu.vo import tracking as jtracking
from pilotguru_tpu_torch.vo import matching, tracking
from pilotguru_tpu_torch.vo.tracking import LOST, OK, CameraModel, MonocularTracker

torch.set_num_threads(1)

TIMES = np.arange(0, 10.0, 0.25)
SCENE_CONFIG = dict(total_budget=256, min_init_matches=40, min_init_inliers=30,
                    min_track_inliers=15, match_search_radius=0.1)


def _frames(scene, times):
    frames = []
    for i, t in enumerate(times):
        kp, desc, valid = scene.frame_features(t)
        k = kp.shape[0]
        frames.append(SimpleNamespace(
            features=(kp, desc, valid, np.zeros(k, np.int32), np.zeros(k, np.float32)),
            dev_features=None, frame_id=i, time_usec=int(t * 1e6)))
    return frames


def _run(frames, chunk, package=tracking, dtype=torch.float64, **overrides):
    """Feed ``frames`` as the segment loop does: chunks of ``chunk`` frames
    in the OK state (0: frame by frame). Returns (tracker, states, frames
    consumed a chunk)."""
    config = package.TrackerConfig(**{**SCENE_CONFIG, **overrides})
    camera = package.CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0)
    if package is tracking:
        tracker = MonocularTracker(camera, config, device="cpu", dtype=dtype)
    else:
        tracker = package.MonocularTracker(camera, config)
    states, consumed = [], []
    buf = list(frames)
    while buf:
        if chunk and tracker.state == OK:
            results = tracker.process_chunk(buf[:chunk])
            states.extend(state for state, _ in results)
            consumed.append(len(results))
            del buf[: len(results)]
        else:
            f = buf.pop(0)
            kp, desc, valid, level, angle = f.features
            states.append(tracker.process_features(kp, desc, valid, f.frame_id, f.time_usec,
                                                   kp_level=level, kp_angle=angle))
    return tracker, states, consumed


# ---------------------------------------------------------- fused_track_chunk
def _pose6(scene, t):
    r_cw, t_cw, _ = scene.camera_pose(t)
    return np.concatenate([tracking.np_matrix_to_rotvec(r_cw), t_cw])


def test_fused_track_chunk_matches_reference():
    scene = SyntheticScene(seed=3)
    rng = np.random.default_rng(4)
    m = 1024
    n = scene.points.shape[0]
    points = np.zeros((m, 3))
    points[:n] = scene.points
    point_desc = np.zeros((m, 256), np.uint8)
    point_desc[:n] = scene.descs
    cand = np.zeros(m, bool)
    cand[:n] = True
    level = np.zeros(m, np.int32)
    dt, t0 = 0.25, 2.0
    pose0 = _pose6(scene, t0)
    motion0 = tracking.MonocularTracker._pose_delta(_pose6(scene, t0 - dt), pose0)
    frames = [scene.frame_features(t0 + (i + 1) * dt) for i in range(16)]
    blackout = 9  # decoys only: under min_track_inliers, the carry freezes
    kp, desc, valid = frames[blackout]
    valid = np.zeros_like(valid)
    valid[:48] = True
    frames[blackout] = (rng.uniform(-0.8, 0.8, kp.shape),
                        rng.integers(0, 2, desc.shape).astype(np.uint8), valid)
    k = frames[0][0].shape[0]
    kw = dict(search_radius=0.1, scale=1.2, level_window=2, refine_radius=0.1,
              huber_delta=1.5 / 250, inlier_threshold=2.5 / 250, min_track_inliers=15)

    want = np.asarray(jtracking.fused_track_chunk(
        jnp.asarray(points), jnp.asarray(point_desc), jnp.asarray(cand), jnp.asarray(level),
        jnp.asarray(pose0), jnp.asarray(motion0),
        tuple(jnp.asarray(f[0]) for f in frames), tuple(jnp.asarray(f[1]) for f in frames),
        tuple(jnp.asarray(f[2]) for f in frames),
        tuple(jnp.zeros(k, jnp.int32) for _ in frames),
        max_distance=jmatching.HAMMING_HIGH, **kw))
    got = tracking.fused_track_chunk(
        torch.from_numpy(points), torch.from_numpy(point_desc), torch.from_numpy(cand),
        torch.from_numpy(level), torch.from_numpy(pose0), torch.from_numpy(motion0),
        [torch.from_numpy(f[0]) for f in frames], [torch.from_numpy(f[1]) for f in frames],
        [torch.from_numpy(f[2]) for f in frames],
        [torch.zeros(k, dtype=torch.int32) for _ in frames],
        max_distance=matching.HAMMING_HIGH, **kw)
    got = got.numpy()

    assert got.shape == want.shape == (16, 7 + 3 * m)
    inliers = want[:, 6]
    assert inliers[blackout] < 15 and (np.delete(inliers, blackout) >= 15).all()
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])
    np.testing.assert_allclose(got[:, :6], want[:, :6], atol=1e-5, rtol=0)
    # After the blackout the carry is frozen: the next frames track from the
    # pose before it, as the reference's scan does.
    assert not np.allclose(want[blackout + 1, :6], want[blackout - 1, :6])


# ------------------------------------------------------- the port's own paths
@pytest.fixture(scope="module")
def rewind_runs():
    per_frame = _run(_frames(SyntheticScene(seed=11), TIMES), 0,
                     chunk_through_keyframes=False)
    chunked = _run(_frames(SyntheticScene(seed=11), TIMES), 8,
                   chunk_through_keyframes=False)
    return per_frame, chunked


def test_chunked_rewinding_at_keyframes_matches_per_frame(rewind_runs):
    (per, per_states, _), (chk, chk_states, consumed) = rewind_runs
    assert chk_states == per_states and LOST not in chk_states
    assert len(consumed) >= 3
    assert [kf.kf_id for kf in chk.keyframes] == [kf.kf_id for kf in per.keyframes]
    per_traj, chk_traj = per.final_trajectory(), chk.final_trajectory()
    assert [fp.frame_id for fp in per_traj] == [fp.frame_id for fp in chk_traj]
    for a, b in zip(per_traj, chk_traj):
        np.testing.assert_allclose(a.pose6, b.pose6, atol=1e-4)


def test_float32_rewinding_chunk_equals_per_frame_exactly():
    """In the card's geometry dtype the chunk's carry still composes the
    motion model on the host in float64, as the per-frame path does, so a
    rewinding chunk tracks each frame from the same prediction: the same
    poses to the bit."""
    runs = [_run(_frames(SyntheticScene(seed=11), TIMES), chunk, dtype=torch.float32,
                 chunk_through_keyframes=False) for chunk in (0, 8)]
    (per, per_states, _), (chk, chk_states, _) = runs
    assert per.dtype == torch.float32 and chk_states == per_states
    assert [kf.kf_id for kf in chk.keyframes] == [kf.kf_id for kf in per.keyframes]
    for a, b in zip(per.final_trajectory(), chk.final_trajectory()):
        np.testing.assert_array_equal(a.pose6, b.pose6)


def test_chunk_through_keyframes_tracks_whole_ride(rewind_runs):
    _, (strict, strict_states, _) = rewind_runs
    thru, thru_states, _ = _run(_frames(SyntheticScene(seed=11), TIMES), 8)
    assert LOST not in thru_states
    assert len(thru_states) == len(strict_states)
    assert len(thru.keyframes) >= 3
    strict_traj = {fp.frame_id: fp.pose6 for fp in strict.final_trajectory()}
    drift = [float(np.linalg.norm(fp.pose6 - strict_traj[fp.frame_id]))
             for fp in thru.final_trajectory() if fp.frame_id in strict_traj]
    assert np.median(drift) < 0.05, f"median pose drift {np.median(drift)}"


def test_chunk_stops_at_tracking_failure():
    """A mid-chunk feature blackout surfaces LOST through the chunked path."""
    frames = _frames(SyntheticScene(seed=5), np.arange(0, 8.0, 0.25))
    rng = np.random.default_rng(9)
    for f in frames:
        if f.time_usec > 4_000_000:  # decoy-only frames
            kp, desc, valid, level, angle = f.features
            valid = np.zeros_like(valid)
            valid[:48] = True
            f.features = (rng.uniform(-0.8, 0.8, size=kp.shape),
                          rng.integers(0, 2, size=desc.shape).astype(np.uint8),
                          valid, level, angle)
    tracker, states, _ = _run(frames, 8, chunk_through_keyframes=False)
    assert LOST in states
    assert tracker.trajectory[-1].is_lost


# ------------------------------------------------- through keyframes, both
def test_through_keyframes_matches_reference(monkeypatch):
    """The JAX tracker and the port's on one feature stream, chunks of 8
    through keyframes, the port's two-view solve given the reference's
    hypotheses (tests/test_torch_slice_replay.py)."""
    keys = {"key": jax.random.PRNGKey(0)}
    solve = tracking.two_view_reconstruction

    def replayed(p1, p2, mask, generator=None, **kwargs):
        keys["key"], sub = jax.random.split(keys["key"])
        weights = jnp.asarray(mask.cpu().numpy()).astype(jnp.float32) + 1e-6
        return solve(p1, p2, mask, samples=_replay(sub, weights, 8, 128), **kwargs)

    monkeypatch.setattr(tracking, "two_view_reconstruction", replayed)
    ref, ref_states, ref_consumed = _run(_frames(SyntheticScene(seed=11), TIMES), 8,
                                         package=jtracking)
    port, port_states, port_consumed = _run(_frames(SyntheticScene(seed=11), TIMES), 8)
    assert port_states == ref_states and LOST not in port_states
    assert port_consumed == ref_consumed
    assert [kf.kf_id for kf in port.keyframes] == [kf.kf_id for kf in ref.keyframes]
    for name in ("points_created", "points_culled", "points_fused"):
        assert port.stats[name] == ref.stats[name]
    ref_traj, port_traj = ref.final_trajectory(), port.final_trajectory()
    assert [fp.frame_id for fp in port_traj] == [fp.frame_id for fp in ref_traj]
    for a, b in zip(port_traj, ref_traj):
        np.testing.assert_allclose(a.pose6, b.pose6, atol=1e-8, rtol=0)


def _closure_error(tracker):
    """End-to-start camera-centre distance over the trajectory's extent
    (tests/test_torch_loopclosing.py's measure)."""
    centres = np.stack([fp.camera_center() for fp in tracker.final_trajectory()
                        if not fp.is_lost])
    extent = np.max(np.linalg.norm(centres - centres.mean(axis=0), axis=1))
    return np.linalg.norm(centres[-1] - centres[0]) / max(extent, 1e-9)


def test_loop_closes_through_chunks_in_float32():
    """The reference's synthetic loop ride (tests/test_loopclosing.py), in
    chunks of 8 through keyframes, float32 geometry and global BA after the
    closure, as the card runs it: the loop closes from a keyframe inserted
    mid-chunk and cuts the closure error five times or more against the
    same chunked ride with loop closing off. Measured: 1 closure, closure
    error 0.00564 against 0.0336 (frame by frame,
    tests/test_torch_loopclosing.py reads 0.00123)."""
    runs = {}
    for on in (False, True):
        scene = LoopScene(seed=0)
        tracker, states, consumed = _run(
            _frames(scene, np.linspace(0, 2 * np.pi, 90)), 8, dtype=torch.float32,
            keyframe_max_gap=4, enable_loop_closing=on, loop_min_match_count=40,
            loop_min_inliers=15, loop_ba="global")
        assert LOST not in states and len(consumed) >= 10
        runs[on] = tracker
    assert runs[False].stats["loop_closures"] == 0
    assert runs[True].stats["loop_closures"] >= 1
    assert _closure_error(runs[True]) < _closure_error(runs[False]) / 5.0


def test_process_chunk_needs_an_initialized_tracker():
    with pytest.raises(ValueError, match="OK state"):
        MonocularTracker(CameraModel(1.0, 1.0, 0.0, 0.0), device="cpu").process_chunk([])
