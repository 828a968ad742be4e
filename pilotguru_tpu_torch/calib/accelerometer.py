"""The IMU+GPS velocity-calibration objective as batched tensor programs
(port of pilotguru_tpu/calib/accelerometer.py).

Reference semantics (AccelerometerCalibrator): 9 parameters per window, a
fixed-frame acceleration bias (~gravity), a device-frame bias and the
initial velocity. The IMU chain is strapdown-integrated across the window;
per GPS interval g the residual is

    r_g = || sum_{pieces p in g} dt_p * v_p || - sum_p dt_p * gps_speed_g

and the loss is sum_g r_g^2. Orientation depends only on the gyro, so the
integrated travel is affine in the 9 parameters and damped Gauss-Newton
converges in a few iterations.

Every function takes windows along the leading dimensions: pieces [W, P]
(one window: W absent), padded pieces carry dt = rate = acc = 0 and
contribute exactly nothing. The reference's ``jax.ops.segment_sum`` over
GPS intervals is a scatter-add in a fixed order (utils/segments.py), so
runs repeat bit for bit on the card and on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pilotguru_tpu_torch.geometry.quaternion import (
    quat_cumulative_product,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)
from pilotguru_tpu_torch.geometry.strapdown import integrate_motion
from pilotguru_tpu_torch.solvers.levenberg_marquardt import (
    LMResult,
    batched_levenberg_marquardt,
)
from pilotguru_tpu_torch.utils.segments import accumulate_rows

NUM_PARAMS = 9  # [global_bias(3), local_bias(3), initial_velocity(3)]


def segment_sum(values, segment_ids, num_segments: int):
    """Sums of ``values`` [..., P, *F] over ``segment_ids`` [..., P] (each in
    [0, num_segments)) per leading index -> [..., num_segments, *F]."""
    lead = segment_ids.shape[:-1]
    p = segment_ids.shape[-1]
    feat = values.shape[segment_ids.dim():]
    rows = segment_ids.reshape(-1, p).long()
    rows = rows + num_segments * torch.arange(rows.shape[0], device=rows.device)[:, None]
    out = values.new_zeros((rows.shape[0] * num_segments,) + feat)
    accumulate_rows(out, rows.reshape(-1), values.reshape((-1,) + feat))
    return out.reshape(lead + (num_segments,) + feat)


class WindowIntegration(NamedTuple):
    orientations: torch.Tensor  # [..., P, 4] post-piece orientations
    velocities: torch.Tensor  # [..., P, 3] post-piece velocities
    travel: torch.Tensor  # [..., G, 3] per-GPS-interval integrated travel
    reference_distance: torch.Tensor  # [..., G] per-interval GPS distance


def _reference_distance(dt, segment_ids, gps_speeds, num_segments):
    speeds = gps_speeds.gather(-1, segment_ids.long())
    return segment_sum(dt * speeds, segment_ids, num_segments)


def integrate_window(params, rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                     num_segments: int) -> WindowIntegration:
    """Strapdown-integrate windows and accumulate per-interval travel: the
    velocity after each piece, weighted by the piece's duration, sums into
    its interval's travel; the GPS distance takes the interval's end-point
    speed as constant over it."""
    integ = integrate_motion(rot_rates, accelerations, dt_sec, params[..., 0:3],
                             params[..., 3:6], params[..., 6:9])
    travel = segment_sum(integ.velocities * dt_sec[..., None], segment_ids, num_segments)
    ref_dist = _reference_distance(dt_sec, segment_ids, gps_speeds, num_segments)
    return WindowIntegration(integ.orientations, integ.velocities, travel, ref_dist)


def _safe_norm(travel):
    # Empty intervals have travel exactly 0; the 1e-30 keeps the norm's
    # derivative finite there (and zero).
    return torch.sqrt((travel * travel).sum(-1) + 1e-30)


def window_residuals(params, rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                     num_segments: int):
    """Per-GPS-interval residuals r_g (zero for empty or padded intervals)."""
    integ = integrate_window(params, rot_rates, accelerations, dt_sec, segment_ids,
                             gps_speeds, num_segments)
    return _safe_norm(integ.travel) - integ.reference_distance


def window_loss(params, rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                num_segments: int):
    """The reference's scalar loss with its 1/total_time normalization
    (velocity.cc:168-170): sum_g r_g^2 over the summed piece durations."""
    r = window_residuals(params, rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                         num_segments)
    return (r * r).sum() / dt_sec.to(r.dtype).sum()


def precompute_affine_travel(rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                             num_segments: int):
    """Per-GPS-interval travel as an affine function of the 9 parameters.

    With R_s the pre-step rotations (from the gyro alone):
      v_t = v0 + sum_{s<=t} dt_s (R_s a_s + R_s b_l + b_g)
      travel_g = sum_{t in g} dt_t v_t = A_g @ p + c_g,   p = [b_g, b_l, v0].
    Returns A [..., G, 3, 9], c [..., G, 3] and the GPS distances [..., G]."""
    dt = dt_sec
    q_post = quat_cumulative_product(rotation_rate_to_quat(rot_rates, dt))
    identity = q_post.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(q_post.shape[:-2] + (1, 4))
    q_pre = torch.cat([identity, q_post[..., :-1, :]], dim=-2)
    r_pre = quat_to_rotation_matrix(q_pre)  # [..., P, 3, 3]

    ra = (r_pre @ accelerations[..., None])[..., 0]  # [..., P, 3]
    cum_ra = torch.cumsum(dt[..., None] * ra, dim=-2)
    cum_r = torch.cumsum(dt[..., None, None] * r_pre, dim=-3)
    cum_t = torch.cumsum(dt, dim=-1)

    c = segment_sum(dt[..., None] * cum_ra, segment_ids, num_segments)
    a_bl = segment_sum(dt[..., None, None] * cum_r, segment_ids, num_segments)
    a_bg_scale = segment_sum(dt * cum_t, segment_ids, num_segments)
    a_v0_scale = segment_sum(dt, segment_ids, num_segments)
    eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
    a = torch.cat([a_bg_scale[..., None, None] * eye, a_bl,
                   a_v0_scale[..., None, None] * eye], dim=-1)  # [..., G, 3, 9]
    return a, c, _reference_distance(dt, segment_ids, gps_speeds, num_segments)


def affine_window_residuals(params, a, c, ref_dist):
    """r_g = ||A_g p + c_g|| - d_g with the same 1e-30 norm guard. params
    [..., 9] against A [..., G, 3, 9] (broadcast)."""
    travel = (a @ params[..., None, :, None])[..., 0] + c
    return _safe_norm(travel) - ref_dist


def affine_window_jacobian(params, a, c, ref_dist):
    """(J [..., G, 9], r [..., G]) of affine_window_residuals: the unit
    travel direction times A_g."""
    travel = (a @ params[..., None, :, None])[..., 0] + c
    norm = _safe_norm(travel)
    jac = ((travel / norm[..., None])[..., None, :] @ a)[..., 0, :]
    return jac, norm - ref_dist


def gravity_init(rot_rates, accelerations, dt_sec):
    """Starting point [..., 9]: the global bias at minus the time-weighted
    mean of the gyro-rotated raw accelerations (a static gravity estimate),
    the rest zero. With zero parameters the final velocity is
    sum_t dt_t R_pre_t a_t, so that mean is v_T / total time."""
    zeros = rot_rates.new_zeros(rot_rates.shape[:-2] + (3,))
    integ = integrate_motion(rot_rates, accelerations, dt_sec, zeros, zeros, zeros)
    g_est = -integ.velocities[..., -1, :] / (dt_sec.sum(-1, keepdim=True) + 1e-30)
    return torch.cat([g_est, rot_rates.new_zeros(g_est.shape[:-1] + (6,))], dim=-1)


# Multi-start v0 directions: the loss only constrains per-interval travel
# norms, so the initial velocity's direction has local minima; each window
# also solves from these directions (horizontal ring), scaled by its first
# GPS speed, and keeps the best.
_SQRT_HALF = 0.7071067811865476
V0_START_DIRECTIONS = (
    (1.0, 0.0, 0.0),
    (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (0.0, -1.0, 0.0),
    (_SQRT_HALF, _SQRT_HALF, 0.0),
    (_SQRT_HALF, -_SQRT_HALF, 0.0),
    (-_SQRT_HALF, _SQRT_HALF, 0.0),
    (-_SQRT_HALF, -_SQRT_HALF, 0.0),
)


def solve_windows(rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                  num_segments: int, num_iters: int = 40) -> LMResult:
    """Damped Gauss-Newton solve of every window at once.

    rot_rates, accelerations [W, P, 3], dt_sec [W, P], segment_ids [W, P],
    gps_speeds [W, B]. Each window solves from 10 starts (zeros, the
    gravity init, the gravity init plus the GPS-scaled v0 directions) as one
    batch of W x 10 problems and keeps the one of lowest loss (the first on
    ties, as argmin does)."""
    a, c, ref_dist = precompute_affine_travel(rot_rates, accelerations, dt_sec, segment_ids,
                                              gps_speeds, num_segments)
    x0g = gravity_init(rot_rates, accelerations, dt_sec)  # [W, 9]
    dirs = x0g.new_tensor(V0_START_DIRECTIONS)  # [8, 3]
    v0 = gps_speeds[:, 1, None, None] * dirs  # [W, 8, 3]
    v0_starts = x0g[:, None, :] + torch.cat([v0.new_zeros(v0.shape[:-1] + (6,)), v0], -1)
    starts = torch.cat([torch.stack([torch.zeros_like(x0g), x0g], dim=1), v0_starts],
                       dim=1)  # [W, 10, 9]
    # Problems [W, S] against each window's A, c, d, broadcast over S.
    a, c, ref_dist = a[:, None], c[:, None], ref_dist[:, None]
    res = batched_levenberg_marquardt(
        lambda x: affine_window_residuals(x, a, c, ref_dist),
        lambda x: affine_window_jacobian(x, a, c, ref_dist),
        starts, num_iters=num_iters,
    )
    best = res.loss.argmin(dim=1, keepdim=True)  # [W, 1]
    return LMResult(
        res.x.gather(1, best[..., None].expand(-1, -1, NUM_PARAMS))[:, 0],
        res.loss.gather(1, best)[:, 0],
        res.iterations.gather(1, best)[:, 0],
        res.converged.gather(1, best)[:, 0],
    )


def replay_windows(params, rot_rates, accelerations, dt_sec):
    """Re-integrate every window with its fitted parameters [W, 9] (the
    reference's IntegrateTrajectory): post-piece orientations [W, P, 4] and
    velocities [W, P, 3]."""
    integ = integrate_motion(rot_rates, accelerations, dt_sec, params[..., 0:3],
                             params[..., 3:6], params[..., 6:9])
    return integ.orientations, integ.velocities
