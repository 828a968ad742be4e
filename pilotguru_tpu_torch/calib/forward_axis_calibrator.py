"""Fixed-forward-axis IMU calibration: the (9 + E)-parameter joint solve
(port of pilotguru_tpu/calib/forward_axis_calibrator.py; the reference's
FixedForwardAxisCalibrator, src/calibration/velocity.cc:258-494).

The parameters are the two acceleration biases, a device-frame forward
axis and one scalar speed per merged IMU event; the loss has three terms:

  1. travel distance, per GPS interval:
       (|| sum_p dt_p * s_{e(p)} * R_pre_p @ axis || - d_gps)^2
  2. acceleration match, per piece:
       || (s_{e(p)+1} R_post_p - s_{e(p)} R_pre_p) @ axis
          - dt_p (b_g + R_pre_p @ (b_l + a_p)) ||^2
  3. axis magnitude: 5e-3 * (||axis|| - 1)^2

solved by the port's damped Gauss-Newton (solvers/levenberg_marquardt.py)
on the stacked residuals, with a dense Jacobian from ``torch.func.jacfwd``
(the system is (9 + E)^2: rides of up to a few thousand merged events, as
in the reference package). After the solve the speeds take the axis's
magnitude (NormalizeVelocities, velocity.cc:472-483).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pilotguru_tpu_torch.calib.accelerometer import segment_sum
from pilotguru_tpu_torch.calib.pieces import RidePieces, build_ride_pieces
from pilotguru_tpu_torch.geometry.quaternion import (
    quat_cumulative_product,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)
from pilotguru_tpu_torch.solvers.levenberg_marquardt import levenberg_marquardt

AXIS_MAGNITUDE_WEIGHT = 5e-3


@dataclass
class FixedForwardAxisResult:
    acceleration_global_bias: np.ndarray  # [3]
    acceleration_local_bias: np.ndarray  # [3]
    forward_axis: np.ndarray  # [3] unit
    velocities: np.ndarray  # [E] scalar speed per merged IMU event
    event_times_usec: np.ndarray  # [E]
    final_loss: float


def _piece_arrays(ride: RidePieces, gps_speeds, dtype, device):
    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    dt = put(ride.piece_dt_sec)
    q_post = quat_cumulative_product(rotation_rate_to_quat(put(ride.piece_rot_rates), dt))
    identity = q_post.new_tensor([1.0, 0.0, 0.0, 0.0])
    q_pre = torch.cat([identity[None, :], q_post[:-1]])
    return {
        "r_pre": quat_to_rotation_matrix(q_pre),  # [P, 3, 3]
        "r_post": quat_to_rotation_matrix(q_post),
        "dt": dt,
        "acc": put(ride.piece_accelerations),
        "ref": put(ride.piece_gps_end_index, torch.int64),
        "event": put(ride.piece_event_index, torch.int64),
        "gps_speed": put(gps_speeds),
    }


def residuals(params, arrays, num_events: int, num_gps: int):
    """Stacked residual vector [G + 3P + 1]."""
    g_bias, l_bias, axis, velocities = params[0:3], params[3:6], params[6:9], params[9:]
    r_pre, r_post = arrays["r_pre"], arrays["r_post"]
    dt, acc, event, ref = arrays["dt"], arrays["acc"], arrays["event"], arrays["ref"]

    s_now = velocities[event]  # [P]
    s_next = velocities[(event + 1).clamp(0, num_events - 1)]
    axis_pre = r_pre @ axis  # [P, 3]
    axis_post = r_post @ axis

    # 1. Travel distance per GPS interval.
    travel = segment_sum(dt[:, None] * s_now[:, None] * axis_pre, ref, num_gps)  # [G, 3]
    ref_dist = segment_sum(dt * arrays["gps_speed"][ref], ref, num_gps)
    r_travel = torch.sqrt((travel * travel).sum(-1) + 1e-30) - ref_dist

    # 2. Acceleration match per piece.
    delta_v_axis = s_next[:, None] * axis_post - s_now[:, None] * axis_pre
    imu_delta_v = dt[:, None] * (g_bias[None, :]
                                 + (r_pre @ (acc + l_bias[None, :])[..., None])[..., 0])
    r_accel = (delta_v_axis - imu_delta_v).reshape(-1)

    # 3. Axis magnitude penalty.
    r_axis = AXIS_MAGNITUDE_WEIGHT ** 0.5 * (torch.linalg.vector_norm(axis) - 1.0)
    return torch.cat([r_travel, r_accel, r_axis[None]])


def loss(params, arrays, num_events: int, num_gps: int):
    """The reference's three-term objective (velocity.cc:291-470)."""
    r = residuals(params, arrays, num_events, num_gps)
    return (r * r).sum()


def initial_state(ride: RidePieces, gps_speeds, dtype=torch.float64, *, device):
    """The start: a gravity estimate for the global bias, a unit x forward
    axis, and per-interval GPS speeds for the speeds (the per-event analog
    of InitToAverages, interpolate_velocity.cc:79-89). Returns (params,
    piece arrays)."""
    arrays = _piece_arrays(ride, gps_speeds, dtype, device)
    total = arrays["dt"].sum() + 1e-30
    rotated = (arrays["r_pre"] @ arrays["acc"][..., None])[..., 0]
    mean_rotated_acc = (arrays["dt"][:, None] * rotated).sum(0) / total
    velocities = np.zeros(ride.num_events)
    np.maximum.at(velocities, ride.piece_event_index,
                  np.asarray(gps_speeds)[ride.piece_gps_end_index])
    params = np.concatenate([-mean_rotated_acc.cpu().numpy().astype(np.float64), np.zeros(3),
                             [1.0, 0.0, 0.0], velocities])
    return torch.as_tensor(params, dtype=dtype, device=device), arrays


def normalize_velocities(params):
    """Scale the axis to unit norm and fold its magnitude into the speeds
    (NormalizeVelocities, velocity.cc:472-483)."""
    params = np.asarray(params, np.float64).copy()
    scale = np.linalg.norm(params[6:9])
    if scale <= 1e-5:
        raise ValueError("degenerate forward axis magnitude")
    params[6:9] /= scale
    params[9:] *= scale
    return params


def calibrate_fixed_forward_axis(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    gps_times_usec,
    gps_speeds,
    num_iters: int = 60,
    dtype=torch.float64,
    device="cuda",
) -> FixedForwardAxisResult:
    """Whole-ride joint solve on ``device`` in ``dtype``. The dense normal
    system is (9 + E)^2, fine up to a few thousand merged events; longer
    rides take the windowed fit_motion pipeline, as the reference does."""
    ride = build_ride_pieces(rot_times_usec, rot_rates, acc_times_usec, accelerations,
                             gps_times_usec)
    num_gps = int(np.asarray(gps_times_usec).shape[0])
    x0, arrays = initial_state(ride, gps_speeds, dtype, device=device)
    result = levenberg_marquardt(
        lambda p: residuals(p, arrays, ride.num_events, num_gps), x0, num_iters=num_iters)
    params = normalize_velocities(result.x.cpu().numpy())
    return FixedForwardAxisResult(
        acceleration_global_bias=params[0:3],
        acceleration_local_bias=params[3:6],
        forward_axis=params[6:9],
        velocities=params[9:],
        event_times_usec=ride.event_times_usec,
        final_loss=float(result.loss),
    )
