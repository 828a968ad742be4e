"""Strapdown IMU integration as parallel scans (port of
pilotguru_tpu/geometry/strapdown.py).

The reference integrates one Euler step at a time (IntegrateMotion):

  a_cal    = a_raw + local_bias                (device frame)
  a_global = R(q_prev) a_cal + global_bias     (fixed frame)
  v        = v_prev + a_global * dt
  q        = q_prev * dq

The orientation chain is an associative product and, given every pre-step
orientation, the velocity chain is a cumulative sum: a log-depth scan and a
cumulative sum, with no loop over time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pilotguru_tpu_torch.geometry.quaternion import (
    quat_cumulative_product,
    quat_rotate,
    rotation_rate_to_quat,
)


class StrapdownResult(NamedTuple):
    orientations: torch.Tensor  # [..., T, 4] post-step orientation q_t
    velocities: torch.Tensor  # [..., T, 3] post-step velocity v_t


def integrate_motion(
    rotation_rates,
    accelerations,
    durations_sec,
    acceleration_global_bias,
    acceleration_local_bias,
    initial_velocity,
    cumsum=torch.cumsum,
):
    """Integrate sequences of IMU steps with calibration parameters.

    rotation_rates [..., T, 3] (rad/s over each step), accelerations
    [..., T, 3] raw samples, durations_sec [..., T]; the biases and the
    initial velocity [..., 3]; the initial orientation is the identity.
    Leading dimensions are independent sequences (windows). Returns
    the post-step orientations and velocities, which match the reference's
    sequential loop up to the reassociation of the scans. ``cumsum(x,
    dim=...)`` sums the velocity increments: a ride-long chain passes
    timeseries.interval_average.blocked_cumsum, whose order is the same on
    every device (CUDA's float32 ``torch.cumsum`` along this strided axis
    drifted 0.091 m/s from float64 over a 300 s ride); fit_motion's short
    windows keep ``torch.cumsum``."""
    dtype = rotation_rates.dtype
    durations_sec = torch.as_tensor(durations_sec, dtype=dtype, device=rotation_rates.device)

    dqs = rotation_rate_to_quat(rotation_rates, durations_sec)  # [..., T, 4]
    q_post = quat_cumulative_product(dqs)
    # Pre-step orientation for step t is q_{t-1} (the identity for t = 0).
    q_first = dqs.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(q_post.shape[:-2] + (1, 4))
    q_pre = torch.cat([q_first, q_post[..., :-1, :]], dim=-2)

    a_cal = accelerations + acceleration_local_bias[..., None, :]
    a_global = quat_rotate(q_pre, a_cal) + acceleration_global_bias[..., None, :]
    dv = a_global * durations_sec[..., None]
    velocities = initial_velocity[..., None, :] + cumsum(dv, dim=-2)
    return StrapdownResult(q_post, velocities)
