"""Relocalization of the port against the JAX package, on the CPU in
float64: the scenarios of tests/test_relocalize.py (the DLT on exact
correspondences, relocalizing from scratch in a mapped scene, the tracker
surviving a break of its motion model) with their assertions, the port's
tracker taking the synthetic scene's features through ``feature_fn``; then
one scene against the JAX package: relocalize on a map the JAX tracker
built, with the JAX function's RANSAC draws replayed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_vo_tracking import SyntheticScene

from pilotguru_tpu.vo import matching as jax_matching
from pilotguru_tpu.vo import relocalize as jax_relocalize
from pilotguru_tpu.vo import tracking as jax_tracking
from pilotguru_tpu_torch.vo.pose import project, rotvec_to_matrix, transform
from pilotguru_tpu_torch.vo.relocalize import dlt_pose, relocalize
from pilotguru_tpu_torch.vo.tracking import CameraModel, MonocularTracker, TrackerConfig

torch.set_num_threads(1)

CONFIG = dict(total_budget=256, min_init_matches=40, min_init_inliers=30,
              min_track_inliers=15, match_search_radius=0.1)


def t(a):
    return torch.from_numpy(np.array(a))


def test_dlt_recovers_pose_from_exact_correspondences():
    rng = np.random.default_rng(0)
    points = np.stack([rng.uniform(-2, 2, 30), rng.uniform(-2, 2, 30),
                       rng.uniform(4, 10, 30)], axis=1)
    true_pose = t([0.1, -0.05, 0.08, 0.3, -0.2, 0.5])
    obs = project(transform(true_pose, t(points)))
    pose = dlt_pose(t(points), obs, torch.ones(30, dtype=torch.float64))
    reproj = project(transform(pose, t(points)))
    err = torch.linalg.vector_norm(reproj - obs, dim=1).numpy()
    assert np.median(err) < 1e-3, np.median(err)


def _mapped_scene():
    scene = SyntheticScene(seed=8)
    tracker = MonocularTracker(CameraModel(1.0, 1.0, 0.0, 0.0), TrackerConfig(**CONFIG),
                               feature_fn=lambda s: scene.frame_features(s),
                               device="cpu", dtype=torch.float64)
    for i, s in enumerate(np.arange(0, 6.0, 0.25)):
        tracker.process_frame(s, i, int(s * 1e6))
    assert tracker.state == "OK"
    return scene, tracker


def test_relocalizes_from_scratch():
    scene, tracker = _mapped_scene()
    kp, desc, valid = scene.frame_features(4.0)
    result = relocalize(t(tracker.points), t(tracker.point_desc), t(tracker.point_valid),
                        t(kp), t(desc), t(valid), generator=torch.Generator().manual_seed(0))
    assert int(result.num_inliers) > 30
    pose = result.pose6.numpy()
    r = rotvec_to_matrix(t(pose[:3])).numpy()
    center = -(r.T @ pose[3:])
    tracked = [fp for fp in tracker.trajectory if abs(fp.time_usec - 4_000_000) < 1]
    assert tracked
    np.testing.assert_allclose(center, tracked[0].camera_center(), atol=0.02)


def test_tracker_survives_motion_model_break():
    scene = SyntheticScene(seed=9)
    tracker = MonocularTracker(
        CameraModel(1.0, 1.0, 0.0, 0.0),
        TrackerConfig(**dict(CONFIG, match_search_radius=0.03)),  # a tight window
        feature_fn=lambda s: scene.frame_features(s), device="cpu", dtype=torch.float64)
    # A jump in time breaks the constant-velocity prediction: only
    # relocalization can recover.
    times = list(np.arange(0, 5.0, 0.25)) + list(np.arange(5.0, 7.0, 0.25) + 1.5)
    states = [tracker.process_frame(s, i, int(s * 1e6)) for i, s in enumerate(times)]
    assert states[-1] == "OK", states[-8:]


# One scene against the JAX package: the JAX tracker maps the scene, and
# both packages' relocalize run on its map arrays with the same 64 draws
# (the JAX function's own, from its key). Measured: the same matches and
# inliers, the pose within 1.2e-17 (float64).
RELOCALIZE_TOL = 1e-10


def test_relocalize_matches_jax_with_replayed_draws():
    scene = SyntheticScene(seed=8)
    tracker = jax_tracking.MonocularTracker(
        jax_tracking.CameraModel(1.0, 1.0, 0.0, 0.0), jax_tracking.TrackerConfig(**CONFIG),
        feature_fn=lambda s: scene.frame_features(s))
    for i, s in enumerate(np.arange(0, 6.0, 0.25)):
        tracker.process_frame(s, i, int(s * 1e6))
    tracker._flush_point_desc()
    kp, desc, valid = scene.frame_features(4.0)
    arrays = (tracker.points, tracker.point_desc, tracker.point_valid, kp, desc, valid)
    key = jax.random.PRNGKey(3)
    want = jax_relocalize.relocalize(*(jnp.asarray(a) for a in arrays), key)
    # The JAX function's draws: six map points a hypothesis, weighted by
    # the match mask (relocalize's hypothesis()).
    m = jax_matching.match_descriptors(
        jnp.asarray(tracker.point_desc), jnp.asarray(desc),
        valid_a=jnp.asarray(tracker.point_valid), valid_b=jnp.asarray(valid),
        max_distance=jax_matching.HAMMING_LOW, ratio=0.8)
    weights = m.valid.astype(jnp.float64) + 1e-9
    samples = np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, weights.shape[0], shape=(6,), replace=False, p=weights / jnp.sum(weights)))(
            jax.random.split(key, 64)))
    got = relocalize(*(t(a) for a in arrays), samples=t(samples))
    np.testing.assert_array_equal(got.matched.numpy(), np.asarray(want.matched))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 30
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6),
                               atol=RELOCALIZE_TOL, rtol=0)
