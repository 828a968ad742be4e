"""SE(3) utilities and robust pose-only optimization (port of
pilotguru_tpu/vo/pose.py).

The camera pose is a 6-vector (so(3) rotation vector + translation,
world->camera); residuals are normalized-plane reprojection errors with
Huber IRLS weights, minimized by solvers.levenberg_marquardt. The functions
take leading batch dimensions where noted and work under ``torch.func``
transforms (no data-dependent Python control flow).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt


def skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def rotvec_to_matrix(w):
    """Rodrigues formula, Taylor-safe near zero. [..., 3] -> [..., 3, 3]."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-30)
    k = skew(w)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_right_jacobian(w):
    """Right Jacobian of the rotation-vector map, [..., 3] -> [..., 3, 3]:
    d(R(w) x)/dw = -R(w) [x]_x J_r(w), the exact derivative of
    ``rotvec_to_matrix``. (1 - cos t)/t^2 is evaluated as 2 sin^2(t/2)/t^2
    and (t - sin t)/t^3 by its series below t = 0.1, so float32 keeps its
    digits near zero rotation."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-30)
    half_sin = torch.sin(theta / 2.0)
    a = 2.0 * half_sin * half_sin / (theta * theta)
    series = 1.0 / 6.0 + theta2 * (
        -1.0 / 120.0 + theta2 * (1.0 / 5040.0 - theta2 / 362880.0)
    )
    b = torch.where(theta2 < 1e-2, series, (theta - torch.sin(theta)) / (theta2 * theta))
    k = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - a[..., None, None] * k + b[..., None, None] * (k @ k)


def projection_jacobian(cam):
    """d project(cam) / d cam, [..., 3] -> [..., 2, 3] (for z > 1e-6)."""
    inv_z = 1.0 / cam[..., 2].clamp_min(1e-6)
    zero = torch.zeros_like(inv_z)
    u = cam[..., 0] * inv_z
    v = cam[..., 1] * inv_z
    return torch.stack(
        [
            torch.stack([inv_z, zero, -u * inv_z], dim=-1),
            torch.stack([zero, inv_z, -v * inv_z], dim=-1),
        ],
        dim=-2,
    )


def rotation_block(d_uv, rotated, r_jr):
    """d uv / d w for cam = R(w) x + t: with d cam/d w = -R [x]_x J_r =
    -[R x]_x R J_r and a^T [p]_x = (a x p)^T, it is
    -(rows of d_uv crossed with R x) @ (R J_r). d_uv [..., 2, 3],
    rotated = R x [..., 3], r_jr [..., 3, 3] -> [..., 2, 3]."""
    return -torch.linalg.cross(d_uv, rotated[..., None, :], dim=-1) @ r_jr


def matrix_to_rotvec(r):
    """Inverse Rodrigues (principal branch). [..., 3, 3] -> [..., 3]."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = ((trace - 1.0) / 2.0).clamp(-1.0, 1.0)
    theta = torch.arccos(cos)
    axis_raw = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]],
        dim=-1,
    )
    sin = torch.linalg.vector_norm(axis_raw, dim=-1) / 2.0
    scale = torch.where(sin > 1e-9, theta / (2.0 * sin), torch.full_like(sin, 0.5))
    return axis_raw * scale[..., None]


def inv3x3(mats):
    """Batched closed-form 3x3 inverse via the adjugate ([..., 3, 3])."""
    a, b, c = mats[..., 0, 0], mats[..., 0, 1], mats[..., 0, 2]
    d, e, f = mats[..., 1, 0], mats[..., 1, 1], mats[..., 1, 2]
    g, h, i = mats[..., 2, 0], mats[..., 2, 1], mats[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    return adj / det[..., None, None]


def transform(pose6, points):
    """Apply world->camera poses: R x + t. pose6 [..., 6], points [..., N, 3]
    -> [..., N, 3]."""
    r = rotvec_to_matrix(pose6[..., :3])
    return points @ r.transpose(-1, -2) + pose6[..., None, 3:]


def compose_pose(delta6, pose6):
    """delta o pose for world->camera 6-vectors (device twin of
    MonocularTracker._compose): R = R_d R_p, t = R_d t_p + t_d."""
    r_d = rotvec_to_matrix(delta6[:3])
    r_p = rotvec_to_matrix(pose6[:3])
    return torch.cat([matrix_to_rotvec(r_d @ r_p), r_d @ pose6[3:] + delta6[3:]])


def pose_delta(prev6, curr6):
    """delta such that curr = delta o prev (device twin of
    MonocularTracker._pose_delta)."""
    r_prev = rotvec_to_matrix(prev6[:3])
    r_d = rotvec_to_matrix(curr6[:3]) @ r_prev.T
    return torch.cat([matrix_to_rotvec(r_d), curr6[3:] - r_d @ prev6[3:]])


def project(points_cam):
    """Pinhole projection to the normalized plane, z-guarded."""
    z = points_cam[..., 2:3].clamp_min(1e-6)
    return points_cam[..., :2] / z


def reprojection_residuals(pose6, points_world, observations, weights):
    """[N, 2] weighted residuals (weights fold in validity and Huber IRLS)."""
    cam = transform(pose6, points_world)
    res = project(cam) - observations
    behind = cam[..., 2] <= 1e-6
    res = torch.where(behind[..., None], torch.ones_like(res), res)
    return res * weights[..., None]


def reprojection_residuals_and_jacobian(pose6, points_world, observations, weights):
    """(J [2N, 6], r [2N]) of ``reprojection_residuals`` in closed form:
    the same values jacfwd gives, without its per-op overhead."""
    r = rotvec_to_matrix(pose6[:3])
    cam = points_world @ r.T + pose6[3:]
    behind = cam[:, 2] <= 1e-6
    res = torch.where(behind[:, None], torch.ones_like(cam[:, :2]),
                      project(cam) - observations) * weights[:, None]
    d_uv = projection_jacobian(cam)  # [N, 2, 3]
    jac = torch.cat(
        [rotation_block(d_uv, cam - pose6[3:], r @ so3_right_jacobian(pose6[:3])), d_uv],
        dim=-1,
    ) * weights[:, None, None]
    jac = torch.where(behind[:, None, None], torch.zeros_like(jac), jac)
    return jac.reshape(-1, 6), res.reshape(-1)


def huber_weights(residual_norms, delta: float):
    """sqrt of the Huber IRLS weight: 1 inside delta, sqrt(delta/|r|) outside."""
    return torch.where(
        residual_norms <= delta,
        torch.ones_like(residual_norms),
        torch.sqrt(delta / residual_norms.clamp_min(1e-12)),
    )


class PoseOptimizationResult(NamedTuple):
    pose6: torch.Tensor  # [6]
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # []


def optimize_pose(
    pose6_init,
    points_world,
    observations,
    valid,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
    irls_rounds: int = 3,
    lm_iters: int = 10,
    obs_invsigma=None,
) -> PoseOptimizationResult:
    """Robust pose-only refinement: ``irls_rounds`` Huber-reweighted LM
    solves, then a final LM polish on the hard inliers only
    (Optimizer::PoseOptimization semantics). ``obs_invsigma`` [N] scales each
    observation's weight and its inlier gate (scale**-level)."""
    dtype = points_world.dtype
    pose = pose6_init.to(dtype)
    if obs_invsigma is None:
        obs_invsigma = torch.ones(observations.shape[:-1], dtype=dtype,
                                  device=points_world.device)
    base_w = valid.to(dtype) * obs_invsigma

    def norms_of(pose):
        cam = transform(pose, points_world)
        res = project(cam) - observations
        return torch.linalg.vector_norm(res, dim=-1) * obs_invsigma, cam[..., 2]

    def solve(pose, w):
        return levenberg_marquardt(
            lambda p: reprojection_residuals(p, points_world, observations, w).reshape(-1),
            pose,
            num_iters=lm_iters,
            residual_and_jacobian=lambda p: reprojection_residuals_and_jacobian(
                p, points_world, observations, w
            ),
        ).x

    for _ in range(irls_rounds):
        norms, _ = norms_of(pose)
        pose = solve(pose, base_w * huber_weights(norms, huber_delta))

    def classify(pose):
        norms, cam_z = norms_of(pose)
        return valid & (norms < inlier_threshold) & (cam_z > 0)

    inliers = classify(pose)
    pose = solve(pose, inliers.to(dtype) * obs_invsigma)
    inliers = classify(pose)
    return PoseOptimizationResult(pose, inliers, inliers.sum())
