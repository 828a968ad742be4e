"""The port's BA oracle, bundle_adjust(solver="dense"), on the CPU in
float64, on the problem of tests/test_vo_core.py::test_schur_matches_dense_solver
(4 poses, 50 points, noisy start, a masked point and three masked
observations, per-observation inverse sigmas).

- the port's dense against its Schur path at that test's atol: poses 1e-5,
  points 1e-4 (measured 1.3e-8 and 2.1e-6), inlier masks equal;
- the port's dense against the JAX package's dense: poses and points
  within 1e-9 (measured 6.7e-16 and 4.6e-14: both run the same fixed 5 + 10
  LM iterations on the same normal equations, and differ in rounding
  only), inlier masks equal, final losses within 1e-12 relative (measured
  1.5e-14);
- the dense Jacobian assembled from the closed-form blocks against
  torch.func.jacfwd of the flat residual, within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.vo import ba as jax_ba
from pilotguru_tpu.vo import pose as jax_pose
from pilotguru_tpu_torch.vo import ba

torch.set_num_threads(1)


def _problem():
    """tests/test_vo_core.py::test_schur_matches_dense_solver's problem, as
    numpy arrays."""
    rng = np.random.default_rng(7)
    k, m = 4, 50
    points = np.stack([rng.uniform(-2, 2, m), rng.uniform(-2, 2, m), rng.uniform(5, 12, m)],
                      axis=1)
    poses = np.zeros((k, 6))
    poses[:, 3] = -0.3 * np.arange(k)
    poses[:, 1] = 0.015 * np.arange(k)
    obs_pose, obs_point, obs_uv = [], [], []
    for i in range(k):
        uv = np.asarray(jax_pose.project(jax_pose.transform(jnp.asarray(poses[i]),
                                                           jnp.asarray(points))))
        obs_pose.extend([i] * m)
        obs_point.extend(range(m))
        obs_uv.append(uv)
    obs_uv = np.concatenate(obs_uv) + rng.normal(scale=3e-4, size=(k * m, 2))
    noisy_poses = poses + rng.normal(scale=0.01, size=poses.shape)
    noisy_poses[0] = poses[0]
    noisy_points = points + rng.normal(scale=0.05, size=points.shape)
    point_valid = np.ones(m, bool)
    point_valid[-1] = False
    obs_valid = np.ones(k * m, bool)
    obs_valid[-3:] = False
    invsigma = rng.uniform(0.5, 1.0, size=k * m)
    return (noisy_poses, noisy_points, np.asarray(obs_pose), np.asarray(obs_point), obs_uv,
            obs_valid, point_valid, invsigma)


@pytest.fixture(scope="module")
def problems():
    arrays = _problem()
    port = ba.BAProblem(*(torch.from_numpy(a) for a in arrays))
    ints = (2, 3)
    ref = jax_ba.BAProblem(*(jnp.asarray(a, jnp.int32) if i in ints else jnp.asarray(a)
                             for i, a in enumerate(arrays)))
    return port, ref, arrays[6]


@pytest.fixture(scope="module")
def port_dense(problems):
    return ba.bundle_adjust(problems[0], solver="dense")


def test_dense_matches_schur(problems, port_dense):
    port, _, point_valid = problems
    schur = ba.bundle_adjust(port)
    np.testing.assert_allclose(schur.poses6.numpy(), port_dense.poses6.numpy(), atol=1e-5)
    np.testing.assert_allclose(schur.points.numpy()[point_valid],
                               port_dense.points.numpy()[point_valid], atol=1e-4)
    np.testing.assert_array_equal(schur.obs_inliers.numpy(), port_dense.obs_inliers.numpy())
    assert port_dense.obs_inliers.numpy().mean() > 0.95


def test_dense_matches_the_jax_dense(problems, port_dense):
    _, ref, _ = problems
    want = jax_ba.bundle_adjust(ref, solver="dense")
    np.testing.assert_allclose(port_dense.poses6.numpy(), np.asarray(want.poses6), atol=1e-9)
    np.testing.assert_allclose(port_dense.points.numpy(), np.asarray(want.points), atol=1e-9)
    np.testing.assert_array_equal(port_dense.obs_inliers.numpy(), np.asarray(want.obs_inliers))
    np.testing.assert_allclose(float(port_dense.final_loss), float(want.final_loss),
                               rtol=1e-12)


def test_closed_form_jacobian_matches_jacfwd(problems):
    port = problems[0]
    rng = np.random.default_rng(3)
    weights = torch.from_numpy(rng.uniform(0.2, 1.0, port.obs_valid.shape[0]))
    flat = torch.cat([port.poses6.reshape(-1), port.points.reshape(-1)])
    flat = flat + torch.from_numpy(rng.normal(scale=1e-3, size=flat.shape[0]))
    anchor, dist = port.poses6[0], torch.tensor(0.31, dtype=torch.float64)
    jac, res = ba._residuals_and_jacobian(flat, port, weights, anchor, dist)
    want = torch.func.jacfwd(lambda f: ba._residuals(f, port, weights, anchor, dist))(flat)
    np.testing.assert_allclose(res.numpy(), ba._residuals(flat, port, weights, anchor,
                                                          dist).numpy(), atol=0)
    np.testing.assert_allclose(jac.numpy(), want.numpy(), atol=1e-12)


def test_unknown_solver_raises(problems):
    with pytest.raises(ValueError, match="solver"):
        ba.bundle_adjust(problems[0], solver="sparse")
