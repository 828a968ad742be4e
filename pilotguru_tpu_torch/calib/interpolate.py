"""GPS-to-frame velocity interpolation as a penalized objective (port of
pilotguru_tpu/calib/interpolate.py; the reference's
GPSInterpolationObjective, src/interpolate_velocity.cc:53-214).

The parameters are one speed per frame timestamp; the objective is

  sum_g  w_v * (L1|L2 of the per-GPS-interval distance mismatch)
  + sum_i w_a * (L1|L2 of the finite-difference acceleration)
  + sum_i w_s * (L1|L2 of consecutive acceleration differences)

minimized by clipped gradient descent (solvers/gradient_descent.py). The
gradient is written in closed form, with the reference's subgradient of
|x|: +1 for x > 0 and -1 otherwise, so -1 at 0, as the reference's
hand-written gradients (interpolate_velocity.cc:119,144,175) and the JAX
package's custom JVP take it. (d|x|/dx = 0 at 0, as autograd of
``torch.abs`` gives, would stall the descent at its start: the averages
it starts from make every acceleration exactly 0.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pilotguru_tpu_torch.calib.accelerometer import segment_sum
from pilotguru_tpu_torch.solvers.gradient_descent import gradient_descent
from pilotguru_tpu_torch.timeseries.merge import make_interpolation_pieces


@dataclass(frozen=True)
class InterpolationSettings:
    l1_weight: float = 0.0
    l2_weight: float = 0.0
    distance_weight: float = 1.0
    accelerations_weight: float = 1.0
    accelerations_smoothness_weight: float = 1.0
    learning_rate: float = 1e-1
    learning_rate_decay: float = 1.0
    iters: int = 1000


def reference_sign(x: torch.Tensor) -> torch.Tensor:
    """The reference's d|x|/dx: 1 where x > 0, else -1 (so -1 at 0)."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


def interpolate_gps_velocities(
    gps_times_usec,
    gps_speeds,
    frame_times_usec,
    settings: InterpolationSettings = InterpolationSettings(),
    dtype=torch.float64,
    device="cuda",
) -> np.ndarray:
    """Per-frame interpolated speeds [F] (float64 numpy), computed on
    ``device`` in ``dtype``."""
    if settings.l1_weight + settings.l2_weight <= 0:
        raise ValueError("l1_weight + l2_weight must be positive")

    gps_times = np.asarray(gps_times_usec, np.int64)
    gps_speeds_np = np.asarray(gps_speeds, np.float64)
    frame_times = np.asarray(frame_times_usec, np.int64)
    pieces = make_interpolation_pieces(gps_times, frame_times)
    num_gps = gps_times.shape[0]
    num_frames = frame_times.shape[0]

    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    piece_dt = put(pieces.duration_sec())
    piece_gps = put(pieces.reference_end_index, torch.int64)
    piece_frame = put(pieces.interpolation_end_index, torch.int64)
    durations = segment_sum(piece_dt, piece_gps, num_gps)
    target = put(gps_speeds_np) * durations
    frame_dt = put(np.diff(frame_times).astype(np.float64) * 1e-6)
    l1, l2 = settings.l1_weight, settings.l2_weight

    def penalty_grad(x, weight):
        # d/dx of weight * (l1 |x| + l2 x^2).
        return weight * (l1 * reference_sign(x) + l2 * (x + x))

    def grad(v):
        dist_diff = segment_sum(v[piece_frame] * piece_dt, piece_gps, num_gps) - target
        accel = (v[1:] - v[:-1]) / frame_dt
        accel_diff = accel[1:] - accel[:-1]
        g_dist = penalty_grad(dist_diff, settings.distance_weight)  # [G]
        g_acc = penalty_grad(accel, settings.accelerations_weight)  # [F-1]
        g_smooth = penalty_grad(accel_diff, settings.accelerations_smoothness_weight)
        # Each sum in the order JAX's reverse pass accumulates it: the later
        # uses of a value first (the shifted differences), then the earlier.
        zero = g_smooth.new_zeros(1)
        g_acc = (torch.cat([zero, g_smooth]) - torch.cat([g_smooth, zero])) + g_acc
        g_acc = g_acc / frame_dt
        g_v = segment_sum(g_dist[piece_gps] * piece_dt, piece_frame, num_frames)
        return (torch.cat([zero, g_acc]) - torch.cat([g_acc, zero])) + g_v

    # Start from the per-interval GPS averages (InitToAverages,
    # interpolate_velocity.cc:79-89): frames covered by a GPS interval
    # start at that interval's speed.
    init = np.zeros(num_frames)
    init[pieces.interpolation_end_index] = gps_speeds_np[pieces.reference_end_index]
    result = gradient_descent(
        grad, put(init), num_iters=int(settings.iters),
        learning_rate=settings.learning_rate,
        learning_rate_decay=settings.learning_rate_decay,
        min_gradient_clip=-10.0, max_gradient_clip=10.0,
    )
    return result.cpu().numpy().astype(np.float64)
