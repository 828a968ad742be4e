"""The port's geometry against the JAX package's on the same float64 inputs:
matching (exact), Levenberg-Marquardt and pose refinement, two-view
initialization and relocalization with the reference's RANSAC draws
replayed, local bundle adjustment, flattening and quaternion smoothing;
plus the port's closed-form Jacobians against torch.func.jacfwd and its
configuration against the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from pilotguru_tpu.formats.trajectory import Trajectory
from pilotguru_tpu.solvers.levenberg_marquardt import levenberg_marquardt as jax_lm
from pilotguru_tpu.timeseries.smoothing import smooth_quaternion_sequence as jax_smooth
from pilotguru_tpu.vo import ba as jba
from pilotguru_tpu.vo import flatten as jflatten
from pilotguru_tpu.vo import matching as jm
from pilotguru_tpu.vo import pose as jpose
from pilotguru_tpu.vo import relocalize as jreloc
from pilotguru_tpu.vo import tracking as jtracking
from pilotguru_tpu.vo import twoview as jtwoview
from pilotguru_tpu.vo.camera import CameraSettings as JaxCameraSettings
from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru_tpu_torch.timeseries.smoothing import smooth_quaternion_sequence
from pilotguru_tpu_torch.vo import ba, flatten, matching, pose, relocalize, tracking, twoview
from pilotguru_tpu_torch.vo.camera import CameraSettings

torch.set_num_threads(1)
F64 = torch.float64


def t(a):
    return torch.from_numpy(np.array(a))


def _descriptors(rng, n, base=None, flips=0):
    if base is None:
        return rng.integers(0, 2, (n, 256)).astype(np.uint8)
    out = base.copy()
    for row in out:
        row[rng.choice(256, flips, replace=False)] ^= 1
    return out


# ------------------------------------------------------------------ matching
def test_matching_exact():
    rng = np.random.default_rng(0)
    a = _descriptors(rng, 300)
    b = np.concatenate([_descriptors(rng, 200, a[:200], flips=20), _descriptors(rng, 150)])
    b[200:210] = a[50:60]  # duplicates: equal distances, ties on purpose
    va = rng.random(300) > 0.1
    vb = rng.random(350) > 0.1
    np.testing.assert_array_equal(
        matching.hamming_table(t(a), t(b), t(va), t(vb)).numpy(),
        np.asarray(jm.hamming_table(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(va), jnp.asarray(vb))).astype(np.int32),
    )
    for mutual in (True, False):
        got = matching.match_descriptors(t(a), t(b), t(va), t(vb), max_distance=50,
                                         ratio=0.9, mutual=mutual)
        want = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                                    jnp.asarray(vb), max_distance=50, ratio=0.9,
                                    mutual=mutual)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got.valid.sum()) > 100

    xy_a = rng.uniform(-0.5, 0.5, (300, 2))
    xy_b = np.concatenate([xy_a[:200] + rng.normal(0, 0.01, (200, 2)),
                           rng.uniform(-0.5, 0.5, (150, 2))])
    la = rng.integers(0, 8, 300).astype(np.int32)
    lb = rng.integers(0, 8, 350).astype(np.int32)
    got = matching.match_projected(t(a), t(xy_a), t(b), t(xy_b), 0.03, t(va), t(vb),
                                   max_distance=100, level_a=t(la), level_b=t(lb))
    want = jm.match_projected(jnp.asarray(a), jnp.asarray(xy_a), jnp.asarray(b),
                              jnp.asarray(xy_b), 0.03, jnp.asarray(va), jnp.asarray(vb),
                              max_distance=100, level_a=jnp.asarray(la),
                              level_b=jnp.asarray(lb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    ang_a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = np.concatenate([ang_a[:200] + 0.3, rng.uniform(-np.pi, np.pi, 150)]).astype(np.float32)
    got_r = matching.rotation_consistency(t(ang_a), t(ang_b), got)
    want_r = jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), want)
    for g, w in zip(got_r, want_r):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ LM and poses
def _scene(rng, n=300, outliers=40, noise=1e-3):
    pose6 = np.array([0.05, -0.1, 0.02, 0.2, -0.1, 0.3])
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    r = np.asarray(jpose.rotvec_to_matrix(jnp.asarray(pose6[:3])))
    cam = pts @ r.T + pose6[3:]
    obs = cam[:, :2] / cam[:, 2:] + rng.normal(0, noise, (n, 2))
    obs[:outliers] += rng.uniform(-0.2, 0.2, (outliers, 2))
    valid = rng.random(n) > 0.05
    return pose6, pts, obs, valid


def test_levenberg_marquardt_matches_reference():
    rng = np.random.default_rng(1)
    x = np.linspace(0, 2, 40)
    y = 2.0 * np.exp(-1.3 * x) + 0.5 + rng.normal(0, 0.01, 40)

    def jres(p):
        return p[0] * jnp.exp(-p[1] * jnp.asarray(x)) + p[2] - jnp.asarray(y)

    def tres(p):
        return p[0] * torch.exp(-p[1] * t(x)) + p[2] - t(y)

    x0 = np.array([1.0, 0.5, 0.0])
    want = jax_lm(jres, jnp.asarray(x0), num_iters=30)
    got = levenberg_marquardt(tres, t(x0), num_iters=30)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-9)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-9)
    # Accepted-step counts can differ by a final step that changes the loss
    # only in its last bits (exp and sums round differently).
    assert bool(got.converged) == bool(want.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3, 2.5])
def test_closed_form_jacobians_match_jacfwd(scale):
    rng = np.random.default_rng(2)
    p6 = np.concatenate([rng.normal(size=3) * scale, rng.normal(size=3) * 0.2])
    _, pts, obs, _ = _scene(rng, n=40)
    pts[0, 2] = -2.0  # one point behind the camera
    w = rng.random(40)
    jac, res = pose.reprojection_residuals_and_jacobian(t(p6), t(pts), t(obs), t(w))
    want = jacfwd(lambda p: pose.reprojection_residuals(p, t(pts), t(obs), t(w)).reshape(-1))(t(p6))
    torch.testing.assert_close(jac, want, atol=1e-10, rtol=0)
    assert torch.equal(res, pose.reprojection_residuals(t(p6), t(pts), t(obs), t(w)).reshape(-1))


def test_optimize_pose_matches_reference():
    rng = np.random.default_rng(3)
    pose6, pts, obs, valid = _scene(rng)
    init = pose6 + np.array([0.01, -0.01, 0.005, 0.05, 0.02, -0.03])
    invs = 1.2 ** -rng.integers(0, 4, len(pts)).astype(np.float64)
    want = jpose.optimize_pose(jnp.asarray(init), jnp.asarray(pts), jnp.asarray(obs),
                               jnp.asarray(valid), huber_delta=0.006,
                               inlier_threshold=0.01, obs_invsigma=jnp.asarray(invs))
    got = pose.optimize_pose(t(init), t(pts), t(obs), t(valid), huber_delta=0.006,
                             inlier_threshold=0.01, obs_invsigma=t(invs))
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6), atol=1e-6)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    # Sanity against the synthetic truth (1e-3 observation noise).
    np.testing.assert_allclose(got.pose6.numpy(), pose6, atol=5e-3)


# ------------------------------------------------------- two-view, reloc
def _jax_samples(key, mask_weights, n, size, count):
    """Replay the reference's RANSAC draws: split the key, one weighted
    choice without replacement per hypothesis."""
    p = mask_weights / jnp.sum(mask_weights)
    keys = jax.random.split(key, count)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(size,), replace=False, p=p)
    )(keys))


def _rotation_angle(ra, rb):
    c = (np.trace(ra.T @ rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("planar", [False, True])
def test_two_view_with_replayed_samples(planar):
    rng = np.random.default_rng(4)
    n = 400
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    np.full(n, 8.0) if planar else rng.uniform(4, 12, n)], 1)
    r21 = np.asarray(jpose.rotvec_to_matrix(jnp.asarray([0.01, -0.04, 0.005])))
    t21 = np.array([0.3, 0.02, 0.1])
    p1 = pts[:, :2] / pts[:, 2:]
    cam2 = pts @ r21.T + t21
    p2 = cam2[:, :2] / cam2[:, 2:] + rng.normal(0, 5e-4, (n, 2))
    p2[:30] += rng.uniform(-0.05, 0.05, (30, 2))
    mask = rng.random(n) > 0.1
    key = jax.random.PRNGKey(5)
    samples = _jax_samples(key, jnp.asarray(mask).astype(jnp.float32) + 1e-6, n, 8, 128)
    want = jtwoview.two_view_reconstruction(jnp.asarray(p1), jnp.asarray(p2),
                                            jnp.asarray(mask), key)
    got = twoview.two_view_reconstruction(t(p1), t(p2), t(mask), samples=t(samples))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.score) == int(want.score) > 200
    assert _rotation_angle(got.rotation.numpy(), np.asarray(want.rotation)) < 1e-6
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-6)
    good = got.inliers.numpy()
    np.testing.assert_allclose(got.points3d.numpy()[good], np.asarray(want.points3d)[good],
                               atol=1e-6)


def test_relocalize_with_replayed_samples():
    rng = np.random.default_rng(6)
    m, k = 500, 600
    pose6, pts, _, _ = _scene(rng, n=m, outliers=0)
    map_desc = _descriptors(rng, m)
    r = np.asarray(jpose.rotvec_to_matrix(jnp.asarray(pose6[:3])))
    cam = pts @ r.T + pose6[3:]
    kp = np.concatenate([cam[:350, :2] / cam[:350, 2:] + rng.normal(0, 5e-4, (350, 2)),
                         rng.uniform(-0.5, 0.5, (k - 350, 2))])
    kp_desc = np.concatenate([_descriptors(rng, 350, map_desc[:350], flips=8),
                              _descriptors(rng, k - 350)])
    map_valid = rng.random(m) > 0.05
    kp_valid = np.ones(k, bool)
    matched = np.asarray(jm.match_descriptors(
        jnp.asarray(map_desc), jnp.asarray(kp_desc), valid_a=jnp.asarray(map_valid),
        valid_b=jnp.asarray(kp_valid), max_distance=jm.HAMMING_LOW, ratio=0.8).valid)
    key = jax.random.PRNGKey(7)
    samples = _jax_samples(key, jnp.asarray(matched).astype(jnp.float64) + 1e-9, m, 6, 64)
    want = jreloc.relocalize(jnp.asarray(pts), jnp.asarray(map_desc), jnp.asarray(map_valid),
                             jnp.asarray(kp), jnp.asarray(kp_desc), jnp.asarray(kp_valid), key)
    got = relocalize.relocalize(t(pts), t(map_desc), t(map_valid), t(kp), t(kp_desc),
                                t(kp_valid), samples=t(samples))
    np.testing.assert_array_equal(got.matched.numpy(), np.asarray(want.matched))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6), atol=1e-6)
    np.testing.assert_allclose(got.pose6.numpy(), pose6, atol=2e-3)


# ------------------------------------------------------------------- BA
def test_bundle_adjust_matches_reference():
    rng = np.random.default_rng(8)
    k, m = 5, 120
    pts = np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(4, 10, m)], 1)
    poses = np.stack([np.array([0.0, 0.02 * i, 0.0, -0.3 * i, 0.0, -0.1 * i])
                      for i in range(k)])
    obs_pose, obs_point, obs_uv = [], [], []
    for i in range(k):
        r = np.asarray(jpose.rotvec_to_matrix(jnp.asarray(poses[i, :3])))
        cam = pts @ r.T + poses[i, 3:]
        seen = rng.random(m) > 0.2
        obs_pose += [i] * int(seen.sum())
        obs_point += list(np.nonzero(seen)[0])
        obs_uv.append(cam[seen, :2] / cam[seen, 2:] + rng.normal(0, 1e-3, (int(seen.sum()), 2)))
    obs_uv = np.concatenate(obs_uv)
    obs_uv[:10] += 0.05  # outliers
    o = len(obs_pose)
    noisy_poses = poses.copy()
    noisy_poses[1:] += rng.normal(0, 5e-3, (k - 1, 6))
    noisy_pts = pts + rng.normal(0, 0.05, pts.shape)
    invs = 1.2 ** -rng.integers(0, 3, o).astype(np.float64)
    args = (noisy_poses, noisy_pts, np.array(obs_pose), np.array(obs_point), obs_uv,
            np.ones(o, bool), np.ones(m, bool), invs)
    want = jba.bundle_adjust(jba.BAProblem(*map(jnp.asarray, args)),
                             huber_delta=0.006, inlier_threshold=0.01)
    got = ba.bundle_adjust(ba.BAProblem(*map(t, args)), huber_delta=0.006,
                           inlier_threshold=0.01)
    # The early exit compares losses; equal up to rounding, so the poses
    # and points agree to float64 rounding amplified by the solve (1e-8).
    np.testing.assert_allclose(got.poses6.numpy(), np.asarray(want.poses6), atol=1e-8)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-8)
    np.testing.assert_array_equal(got.obs_inliers.numpy(), np.asarray(want.obs_inliers))
    np.testing.assert_allclose(float(got.final_loss), float(want.final_loss), rtol=1e-8)


# ------------------------------------------------- flatten and smoothing
def _trajectory(n=80):
    s = np.arange(n, dtype=np.float64)
    yaw = 0.3 * np.sin(s / 15.0)
    translations = np.stack([np.sin(s / 20.0) * 2, 0.01 * np.cos(s / 7.0), s * 0.1], 1)
    rotations = np.stack([np.cos(yaw / 2), 0.02 * np.sin(s / 5.0), np.sin(yaw / 2),
                          np.zeros(n)], 1)
    rotations /= np.linalg.norm(rotations, axis=1, keepdims=True)
    return Trajectory(np.arange(n, dtype=np.int64) * 33_000, np.arange(n, dtype=np.int64),
                      np.zeros(n, bool), translations, rotations)


def test_flatten_matches_reference():
    traj = _trajectory()
    got = flatten.flatten_trajectory(traj)
    want = jflatten.flatten_trajectory(traj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-12)
    flat = _trajectory()
    flat.translations[:, 1] = 0.5 * flat.translations[:, 0]  # still planar
    flat.translations[:, 1] += np.linspace(0, 3, 80) ** 2  # not planar
    assert flatten.flatten_trajectory(flat) is None
    assert jflatten.flatten_trajectory(flat) is None


@pytest.mark.parametrize("sigma", [1, 3])
def test_smooth_quaternions_matches_reference(sigma):
    q = _trajectory().rotations
    got = smooth_quaternion_sequence(q, sigma, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax_smooth(q, sigma)), atol=1e-12)
    with pytest.raises(ValueError):
        smooth_quaternion_sequence(q, 0, device="cpu")


# ------------------------------------------------------------ configuration
def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_configs_match_reference():
    """Same fields and defaults as the reference (chunks of 16 through
    keyframes among them), but for the extractor's patch path, which the
    reference reads from PGTPU_PATCH_IMPL instead of its config."""
    port = _fields(tracking.TrackerConfig)
    ref = _fields(jtracking.TrackerConfig)
    assert set(port) - set(ref) == {"patch_impl"} and set(ref) <= set(port)
    differ = {k for k in ref if port[k] != ref[k]}
    assert differ == set()
    assert port["track_chunk_frames"] == 16 and port["chunk_through_keyframes"] is True
    assert port["enable_loop_closing"] is True
    assert port["patch_impl"] == "blur_then_gather"
    assert _fields(CameraSettings) == _fields(JaxCameraSettings)
    assert _fields(tracking.CameraModel) == _fields(jtracking.CameraModel)


def test_patch_impl_is_checked():
    assert tracking.TrackerConfig(patch_impl="fused").patch_impl == "fused"
    with pytest.raises(ValueError, match="patch_impl"):
        tracking.TrackerConfig(patch_impl="pallas")


def test_camera_normalization_matches_reference():
    cam_args = dict(fx=700.0, fy=690.0, cx=640.0, cy=360.0, k1=-0.28, k2=0.07,
                    p1=1e-3, p2=-5e-4)
    xy = np.random.default_rng(9).uniform([0, 0], [1280, 720], (200, 2)).astype(np.float32)
    port_cam = tracking.CameraModel(**cam_args)
    want = jtracking.CameraModel(**cam_args).normalize(xy)
    np.testing.assert_array_equal(port_cam.normalize(xy), want)
    got_dev = tracking.normalize_keypoints_device(t(xy), port_cam).numpy()
    np.testing.assert_allclose(got_dev, want, atol=1e-6)
    np.testing.assert_allclose(port_cam.denormalize(port_cam.normalize(xy.astype(np.float64))),
                               xy, atol=1e-3)
