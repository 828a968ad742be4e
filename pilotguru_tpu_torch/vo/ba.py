"""Local bundle adjustment: Schur-complement Levenberg-Marquardt (port of
pilotguru_tpu/vo/ba.py).

Per-observation 2x9 Jacobians (closed form, held against torch.func.jacfwd
in the tests), summed into per-pose
6x6 / per-point 3x3 normal-equation blocks plus the pose-point coupling W;
closed-form 3x3 point-block inverses; one dense 6K x 6K reduced-camera
solve per iteration. Gauge freedom (6 DOF + monocular scale) is pinned by
prior residuals on the first pose and on the first-to-second camera-centre
distance.

The reference's device ``while_loop`` with early exit is a Python loop here:
each iteration reads the ``done`` flag on the host (one sync per LM
iteration).

``solver="dense"`` keeps the JAX package's cross-check oracle: the flat
(6K + 3M)-parameter residual (``_residuals``) through the general
solvers/levenberg_marquardt.py, with a dense Jacobian assembled from the
same closed-form blocks, under the same IRLS rounds, Huber weights and
inlier gate. Its Jacobian holds (2O + 7) x (6K + 3M) reals and its normal
matrix (6K + 3M)^2, so it is for tests and checks; the tracker never takes
it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt
from pilotguru_tpu_torch.utils import linalg
from pilotguru_tpu_torch.utils.segments import accumulate_rows
from pilotguru_tpu_torch.vo.pose import (
    huber_weights,
    inv3x3,
    project,
    projection_jacobian,
    rotation_block,
    rotvec_to_matrix,
    skew,
    so3_right_jacobian,
)


class BAProblem(NamedTuple):
    poses6: torch.Tensor  # [K, 6]
    points: torch.Tensor  # [M, 3]
    obs_pose: torch.Tensor  # [O] int64
    obs_point: torch.Tensor  # [O] int64
    obs_uv: torch.Tensor  # [O, 2] normalized coordinates
    obs_valid: torch.Tensor  # [O] bool
    point_valid: torch.Tensor  # [M] bool
    # [O] inverse noise scale per observation (scale**-level of the
    # observing keypoint); None means uniform.
    obs_invsigma: Optional[torch.Tensor] = None


class BAResult(NamedTuple):
    poses6: torch.Tensor
    points: torch.Tensor
    obs_inliers: torch.Tensor  # [O] bool
    final_loss: torch.Tensor


def _camera_center(pose6):
    r = rotvec_to_matrix(pose6[:3])
    return -(r.T @ pose6[3:])


def _observation_terms(poses, points, problem: BAProblem, weights,
                       jacobian: bool = True):
    """Weighted residuals [O, 2] and (when ``jacobian``) their closed-form
    Jacobian blocks with respect to the observing pose, A [O, 2, 6], and the
    point, B [O, 2, 3]. Behind-camera observations get a constant residual
    and zero slope."""
    rot = rotvec_to_matrix(poses[:, :3])  # [K, 3, 3]
    r = rot[problem.obs_pose]  # [O, 3, 3]
    rotated = (r @ points[problem.obs_point][..., None])[..., 0]
    cam = rotated + poses[problem.obs_pose, 3:]
    behind = cam[:, 2] <= 1e-6
    w = weights[:, None]
    res = torch.where(behind[:, None], torch.ones_like(cam[:, :2]),
                      project(cam) - problem.obs_uv) * w
    if not jacobian:
        return res
    d_uv = projection_jacobian(cam) * w[..., None]  # [O, 2, 3]
    d_uv = torch.where(behind[:, None, None], torch.zeros_like(d_uv), d_uv)
    r_jr = (rot @ so3_right_jacobian(poses[:, :3]))[problem.obs_pose]
    d_pose = torch.cat([rotation_block(d_uv, rotated, r_jr), d_uv], dim=-1)
    return res, d_pose, d_uv @ r


def _camera_center_jacobian(pose6):
    """d(-R^T t)/d[w, t] [3, 6]: R^T t = R(-w) t, so the rotation block is
    -R^T [t]_x J_r(-w) and the translation block -R^T."""
    rt = rotvec_to_matrix(pose6[:3]).T
    return torch.cat(
        [-(rt @ skew(pose6[3:])) @ so3_right_jacobian(-pose6[:3]), -rt], dim=1
    )


def _prior_residuals(poses, gauge_anchor, anchor_dist):
    """Gauge priors [7]: pose 0 pinned entirely, and the first-to-second
    camera-centre distance (monocular scale)."""
    i1 = min(1, poses.shape[0] - 1)
    pose0_prior = 1e3 * (poses[0] - gauge_anchor)
    gap = _camera_center(poses[i1]) - _camera_center(poses[0])
    scale_prior = 1e2 * (torch.linalg.vector_norm(gap) - anchor_dist)
    return torch.cat([pose0_prior, scale_prior[None]])


def _prior_jacobian(poses):
    """[7, 6K]: 1e3 I on pose 0, then the scale prior's row."""
    k = poses.shape[0]
    i1 = min(1, k - 1)
    jac = torch.zeros((7, 6 * k), dtype=poses.dtype, device=poses.device)
    jac[:6, :6] = 1e3 * torch.eye(6, dtype=poses.dtype, device=poses.device)
    gap = _camera_center(poses[i1]) - _camera_center(poses[0])
    unit = 1e2 * gap / torch.linalg.vector_norm(gap).clamp_min(1e-30)
    jac[6, 6 * i1 : 6 * i1 + 6] += unit @ _camera_center_jacobian(poses[i1])
    jac[6, :6] -= unit @ _camera_center_jacobian(poses[0])
    return jac


def _unflatten(flat, problem: BAProblem):
    k, m = problem.poses6.shape[0], problem.points.shape[0]
    return flat[: 6 * k].reshape(k, 6), flat[6 * k :].reshape(m, 3)


def _residuals(flat, problem: BAProblem, weights, gauge_anchor, anchor_dist):
    """The dense oracle's residual over the flat [6K + 3M] parameters:
    the weighted observations [2O] (a constant behind the camera), then the
    gauge priors [7]."""
    poses, points = _unflatten(flat, problem)
    res = _observation_terms(poses, points, problem, weights, jacobian=False)
    return torch.cat([res.reshape(-1), _prior_residuals(poses, gauge_anchor, anchor_dist)])


def _residuals_and_jacobian(flat, problem: BAProblem, weights, gauge_anchor,
                            anchor_dist):
    """(J [2O + 7, 6K + 3M], r [2O + 7]) of ``_residuals``, J assembled from
    the closed-form per-observation blocks (each entry written once)."""
    poses, points = _unflatten(flat, problem)
    k = poses.shape[0]
    res, a_blk, b_blk = _observation_terms(poses, points, problem, weights)
    o = res.shape[0]
    device = flat.device
    jac = torch.zeros((2 * o + 7, flat.shape[0]), dtype=flat.dtype, device=device)
    rows = torch.arange(2 * o, device=device).reshape(o, 2, 1)
    pose_cols = 6 * problem.obs_pose[:, None] + torch.arange(6, device=device)
    point_cols = 6 * k + 3 * problem.obs_point[:, None] + torch.arange(3, device=device)
    jac[rows, pose_cols[:, None, :]] = a_blk
    jac[rows, point_cols[:, None, :]] = b_blk
    jac[2 * o :, : 6 * k] = _prior_jacobian(poses)
    return jac, torch.cat([res.reshape(-1),
                           _prior_residuals(poses, gauge_anchor, anchor_dist)])


def _schur_lm(
    problem: BAProblem,
    weights,
    gauge_anchor,
    anchor_dist,
    num_iters: int,
    init_damping: float = 1e-3,
    damping_down: float = 1.0 / 3.0,
    min_damping: float = 1e-12,
    max_damping: float = 1e12,
    grad_tol: float = 1e-10,
    diag_regularization: float = 1e-12,
    ftol: float = 1e-7,
):
    """One IRLS round of BA as Schur-complement LM (weights fixed).

    Stops after ``num_iters`` iterations, or earlier when the gradient is
    tiny, an accepted step improves the loss by less than ``ftol``
    relative, or the model cannot promise an ftol-sized reduction.
    Returns (poses6 [K, 6], points [M, 3], loss [])."""
    k = problem.poses6.shape[0]
    m = problem.points.shape[0]
    dtype, device = problem.points.dtype, problem.points.device
    obs_p = problem.obs_pose
    obs_l = problem.obs_point
    eye_p = torch.eye(6 * k, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    def loss_of(poses, points):
        res = _observation_terms(poses, points, problem, weights, jacobian=False)
        pr = _prior_residuals(poses, gauge_anchor, anchor_dist)
        return (res * res).sum() + (pr * pr).sum()

    def segment_sum(values, index, segments):
        # A fixed summation order, so a BA, and with it a whole ride, gives
        # the same float32 result run after run.
        out = torch.zeros((segments,) + values.shape[1:], dtype=dtype, device=device)
        return accumulate_rows(out, index, values)

    poses, points = problem.poses6, problem.points
    damping = torch.full((), init_damping, dtype=dtype, device=device)
    nu = torch.full((), 3.0, dtype=dtype, device=device)
    down = torch.full((), damping_down, dtype=dtype, device=device)
    loss = loss_of(poses, points)
    for _ in range(num_iters):
        res, a_blk, b_blk = _observation_terms(poses, points, problem, weights)
        h_pp = segment_sum(torch.einsum("oia,oib->oab", a_blk, a_blk), obs_p, k)
        g_p = segment_sum(torch.einsum("oia,oi->oa", a_blk, res), obs_p, k)
        h_ll = segment_sum(torch.einsum("oia,oib->oab", b_blk, b_blk), obs_l, m)
        g_l = segment_sum(torch.einsum("oia,oi->oa", b_blk, res), obs_l, m)
        w_pl = segment_sum(
            torch.einsum("oia,oib->oab", a_blk, b_blk), obs_l * k + obs_p, m * k
        ).reshape(m, k, 6, 3)

        pr = _prior_residuals(poses, gauge_anchor, anchor_dist)
        j_pr = _prior_jacobian(poses)  # [7, 6K]
        p_full = torch.block_diag(*h_pp) + j_pr.T @ j_pr
        g_pose = g_p.reshape(-1) + j_pr.T @ pr

        diag_p = p_full.diagonal() + diag_regularization
        diag_l = h_ll.diagonal(dim1=-2, dim2=-1) + diag_regularization  # [M, 3]
        p_damped = p_full + damping * torch.diag(diag_p) + diag_regularization * eye_p
        h_ll_damped = h_ll + (damping * diag_l + diag_regularization)[..., None] * eye3
        h_ll_inv = inv3x3(h_ll_damped)

        # Reduced camera system: S = P - W Hll^-1 W^T, rhs = -gp + W Hll^-1 gl.
        w_hinv = torch.einsum("mkia,mab->mkib", w_pl, h_ll_inv)
        s = p_damped - torch.einsum("mkib,mljb->kilj", w_hinv, w_pl).reshape(6 * k, 6 * k)
        rhs = -g_pose + torch.einsum("mkib,mb->ki", w_hinv, g_l).reshape(-1)
        dx_p = linalg.solve_ex(s, rhs)[0]
        dx_l = -torch.einsum(
            "mab,mb->ma", h_ll_inv,
            g_l + torch.einsum("mkia,ki->ma", w_pl, dx_p.reshape(k, 6)),
        )

        poses_try = poses + dx_p.reshape(k, 6)
        points_try = points + dx_l
        loss_try = loss_of(poses_try, points_try)

        predicted = dx_p @ (damping * (diag_p * dx_p) - g_pose) + (
            dx_l * (damping * (diag_l * dx_l) - g_l)
        ).sum()
        rho = (loss - loss_try) / predicted.clamp_min(1e-300)
        accept = (loss_try < loss) & (predicted > 0)
        grad_small = torch.maximum(
            (2.0 * g_pose).abs().max(), (2.0 * g_l).abs().max()
        ) < grad_tol
        converged = accept & (loss - loss_try < ftol * loss)
        stalled = predicted < ftol * loss
        done = grad_small | converged | stalled

        poses = torch.where(accept, poses_try, poses)
        points = torch.where(accept, points_try, points)
        loss = torch.where(accept, loss_try, loss)
        shrink = torch.maximum(down, 1.0 - (2.0 * rho - 1.0) ** 3)
        damping = torch.where(accept, damping * shrink, damping * nu).clamp(
            min_damping, max_damping
        )
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        if bool(done):
            break
    return poses, points, loss


def _observation_norms(poses, points, problem: BAProblem):
    r = rotvec_to_matrix(poses[problem.obs_pose, :3])  # [O, 3, 3]
    cam = (r @ points[problem.obs_point][..., None])[..., 0] + poses[problem.obs_pose, 3:]
    return torch.linalg.vector_norm(project(cam) - problem.obs_uv, dim=-1)


def bundle_adjust(
    problem: BAProblem,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
    lm_iters: Sequence[int] = (5, 10),
    solver: str = "schur",
) -> BAResult:
    """Robust local BA: one IRLS Huber reweighting round per entry of
    ``lm_iters``, each an LM solve capped at that many iterations. The
    default (5, 10) is the reference's LocalBundleAdjustment budget
    (Optimizer.cc:660,707: optimize(5), outlier reweight, optimize(10)).

    ``solver``: "schur" (the default, with early exit) or "dense", the
    flat-parameter oracle that runs every iteration (module docstring)."""
    if solver not in ("schur", "dense"):
        raise ValueError(f"solver={solver!r}: want 'schur' or 'dense'")
    k = problem.poses6.shape[0]
    dtype = problem.points.dtype
    invsigma = (
        problem.obs_invsigma
        if problem.obs_invsigma is not None
        else torch.ones_like(problem.obs_valid, dtype=dtype)
    )
    base_w = (
        problem.obs_valid & problem.point_valid[problem.obs_point]
    ).to(dtype) * invsigma
    gauge_anchor = problem.poses6[0]
    anchor_dist = torch.linalg.vector_norm(
        _camera_center(problem.poses6[min(1, k - 1)]) - _camera_center(problem.poses6[0])
    )
    poses, points = problem.poses6, problem.points
    loss = torch.zeros((), dtype=dtype, device=points.device)
    for round_iters in lm_iters:
        # Huber and the inlier gate act on sigma-scaled norms.
        norms = _observation_norms(poses, points, problem) * invsigma
        w = base_w * huber_weights(norms, huber_delta)
        if solver == "schur":
            poses, points, loss = _schur_lm(
                problem._replace(poses6=poses, points=points), w,
                gauge_anchor, anchor_dist, num_iters=round_iters,
            )
            continue
        result = levenberg_marquardt(
            lambda f: _residuals(f, problem, w, gauge_anchor, anchor_dist),
            torch.cat([poses.reshape(-1), points.reshape(-1)]),
            num_iters=round_iters,
            residual_and_jacobian=lambda f: _residuals_and_jacobian(
                f, problem, w, gauge_anchor, anchor_dist),
        )
        (poses, points), loss = _unflatten(result.x, problem), result.loss
    norms = _observation_norms(poses, points, problem) * invsigma
    inliers = (norms < inlier_threshold) & problem.obs_valid
    return BAResult(poses, points, inliers, loss)
