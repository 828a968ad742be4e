"""End-to-end fit_motion: IMU + GPS -> velocities, steering, forward axis
(port of pilotguru_tpu/calib/fit_motion.py).

  1. Principal-rotation-axis PCA -> the vehicle's vertical axis.
  2. Steering signal: gyro rates projected on the vertical axis.
  3. Sliding-window IMU calibration: every window solves at once as one
     batched Gauss-Newton program (the reference binary runs one L-BFGS per
     window, one after another); the per-window replays, the cross-window
     speed averaging and the forward-axis sum are scatter-adds and sums.
  4. Gaussian post-smoothing of the averaged speeds.
  5. Forward axis: the device-frame velocity summed over confident windows,
     vertical component removed, normalized.

Steps 1 to 4 run on ``FitMotionConfig.device`` (the card unless the caller
asks for the CPU); the timestamps stay int64 numpy on the host, as the
piece decomposition (calib/pieces.py) does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pilotguru_tpu_torch.calib.accelerometer import (
    segment_sum,
    solve_windows,
    window_residuals,
)
from pilotguru_tpu_torch.calib.pieces import WindowedProblem, build_ride_pieces
from pilotguru_tpu_torch.calib.rotation_axis import (
    angular_velocities_around_axis,
    principal_rotation_axes,
)
from pilotguru_tpu_torch.geometry.quaternion import quat_conjugate, quat_rotate
from pilotguru_tpu_torch.geometry.strapdown import integrate_motion
from pilotguru_tpu_torch.parallel.mesh import Mesh, gather_leading_axis, shard_leading_axis
from pilotguru_tpu_torch.timeseries.smoothing import smooth_time_series
from pilotguru_tpu_torch.utils.profiling import StageTimer


@dataclass(frozen=True)
class FitMotionConfig:
    """Mirrors the reference flags, plus where and in what type to compute."""

    locations_batch_size: int = 40
    locations_shift_step: int = 5
    optimization_iters: int = 40  # Gauss-Newton; the reference's L-BFGS used 500.
    post_smoothing_sigma_sec: float = 0.003
    principal_rotation_axis_integration_interval_usec: int = 500_000
    forward_axis_inference_min_velocity_m_s: float = 5.0
    forward_axis_inference_min_rotation_rad: float = 0.2
    dtype: torch.dtype = torch.float64
    device: str = "cuda"


@dataclass
class FitMotionResult:
    vertical_axis: np.ndarray  # [3]
    steering_times_usec: np.ndarray  # [R] (= rotation timestamps)
    steering_angular_velocities: np.ndarray  # [R]
    velocity_times_usec: np.ndarray  # [E'] covered merged-IMU-event times
    velocities_m_s: np.ndarray  # [E'] smoothed averaged speeds
    forward_axis: np.ndarray  # [3] unit, in device frame
    window_params: np.ndarray  # [W, 9] fitted calibration parameters
    window_final_loss: np.ndarray  # [W] final sum-of-squares residuals


def _solve_and_reduce(
    piece_rot,  # [P, 3] flat piece arrays, on the device
    piece_acc,  # [P, 3]
    piece_dt,  # [P]
    piece_gps_end,  # [P] int64
    piece_event,  # [P] int64
    piece_next_differs,  # [P] bool
    gps_speeds,  # [G]
    window_lo,  # [W] int64: first global piece index per window
    window_hi,  # [W] int64
    window_start,  # [W] int64: the window's first GPS index
    num_gps: int,
    max_pieces: int,
    batch_size: int,
    num_events: int,
    num_iters: int,
    min_velocity: float,
    min_rotation_rad: float,
    mesh: Optional[Mesh] = None,
):
    """Window gather and padding, the batched solve, the replay and the
    cross-window reductions on the pieces' device. With a ``mesh`` of
    several devices, the solve and the replay run on its devices, each on
    a contiguous block of windows (parallel/mesh.py), and their results
    are gathered back in window order: every window's arithmetic and every
    reduction are the unsharded run's. Returns (LMResult over windows,
    per-event speed sums [E], per-event counts [E], the forward-axis sum
    [3])."""
    dtype, device = piece_rot.dtype, piece_rot.device
    num_pieces = piece_rot.shape[0]

    offs = torch.arange(max_pieces, device=device)
    gidx = window_lo[:, None] + offs[None, :]  # [W, Pmax]
    valid = gidx < window_hi[:, None]
    gidx_c = gidx.clamp_max(num_pieces - 1)
    fvalid = valid.to(dtype)

    rot_rates = piece_rot[gidx_c] * fvalid[..., None]
    accelerations = piece_acc[gidx_c] * fvalid[..., None]
    dt_sec = piece_dt[gidx_c] * fvalid
    segment_ids = torch.where(valid, piece_gps_end[gidx_c] - window_start[:, None], 0)
    event_ids = piece_event[gidx_c]
    # Last piece of its IMU event within the window.
    event_last = valid & (piece_next_differs[gidx_c] | (gidx == window_hi[:, None] - 1))
    out_weights = event_last.to(dtype)

    widx = window_start[:, None] + torch.arange(batch_size, device=device)[None, :]
    wvalid = widx < (window_start[:, None] + batch_size).clamp_max(num_gps)
    gps_speeds_w = torch.where(wvalid, gps_speeds[widx.clamp_max(num_gps - 1)], 0.0)

    windows = (rot_rates, accelerations, dt_sec, segment_ids, gps_speeds_w)
    if mesh is None or mesh.size == 1:
        sol, orient, vel = _solve_and_replay(*windows, batch_size, num_iters)
    else:
        # Each device solves and replays its contiguous block of windows;
        # the blocks come back in window order before any cross-window sum.
        blocks = [b for b in shard_leading_axis(windows, mesh, mesh.axis_names[0])
                  if b[0].shape[0] > 0]
        sol, orient, vel = gather_leading_axis(
            [_solve_and_replay(*b, batch_size, num_iters) for b in blocks], device)
    speeds = torch.linalg.vector_norm(vel, dim=-1)  # [W, P]

    # Cross-window per-event speed averaging: each window contributes each
    # covered event's final-piece speed.
    flat_ids = event_ids.reshape(1, -1)
    flat_w = out_weights.reshape(1, -1)
    ev_sum = segment_sum(speeds.reshape(1, -1) * flat_w, flat_ids, num_events)[0]
    ev_count = segment_sum(flat_w, flat_ids, num_events)[0]

    # Forward-axis accumulation: windows gated by their overall rotation
    # (min |q.w| over the window's event orientations), events by speed;
    # velocities rotated into the device frame.
    abs_w = torch.where(out_weights > 0, orient[..., 0].abs(), torch.inf)
    min_cos = abs_w.amin(dim=1).clamp(-1.0, 1.0)  # [W]
    window_gate = torch.arccos(min_cos) >= min_rotation_rad
    ev_gate = out_weights * (speeds >= min_velocity) * window_gate[:, None]
    v_local = quat_rotate(quat_conjugate(orient), vel)  # [W, P, 3]
    forward_total = (v_local * ev_gate[..., None]).sum(dim=(0, 1))
    return sol, ev_sum, ev_count, forward_total


def _solve_and_replay(rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                      batch_size: int, num_iters: int):
    """The batched solve of windows [W, P] and the replay of each window
    under its solution: (LMResult, orientations [W, P, 4], velocities
    [W, P, 3]), on the windows' device."""
    sol = solve_windows(rot_rates, accelerations, dt_sec, segment_ids, gps_speeds,
                        batch_size, num_iters=num_iters)
    replay = integrate_motion(rot_rates, accelerations, dt_sec, sol.x[:, 0:3],
                              sol.x[:, 3:6], sol.x[:, 6:9])
    return sol, replay.orientations, replay.velocities


def build_window_index(ride, gps_times_usec, batch_size: int, shift_step: int):
    """Sliding GPS windows -> contiguous piece slices.

    Returns (lo, hi, starts, pmax): per window the first and one-past-last
    global piece index and the first GPS index, and the padded per-window
    piece budget (rounded up to a multiple of 8)."""
    gps_times = np.asarray(gps_times_usec, np.int64)
    num_gps = gps_times.shape[0]
    starts = np.arange(0, num_gps, shift_step, dtype=np.int64)
    ends = np.minimum(starts + batch_size, num_gps)
    lo = np.searchsorted(ride.piece_end_usec, gps_times[starts], side="right")
    hi = np.searchsorted(ride.piece_end_usec, gps_times[ends - 1], side="right")
    hi = np.maximum(hi, lo)
    pmax = int(np.max(hi - lo)) if starts.size else 1
    pmax = max(-(-pmax // 8) * 8, 8)
    return lo, hi, starts, pmax


def fit_motion_arrays(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    gps_times_usec,
    gps_speeds,
    config: FitMotionConfig = FitMotionConfig(),
    timer=None,
    mesh: Optional[Mesh] = None,
) -> FitMotionResult:
    """Run the whole pipeline on in-memory arrays (host numpy in, host
    numpy out). Pass a utils.profiling.StageTimer for per-stage wall times;
    each stage ends with its results on the host or a synchronisation, so
    the times are the device's too. ``mesh`` (parallel/mesh.py) spreads the
    windows' solve and replay over its devices (``_solve_and_reduce``);
    the rest runs on ``config.device``, and the result is the unsharded
    one."""
    timer = timer or StageTimer("fit_motion")
    dtype, device = config.dtype, torch.device(config.device)

    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    with timer.stage("rotation_axis_pca"):
        axes, _ = principal_rotation_axes(
            rot_times_usec, rot_rates,
            config.principal_rotation_axis_integration_interval_usec, dtype, device=device,
        )
        vertical = axes[0]
        steering = angular_velocities_around_axis(put(rot_rates), vertical).cpu().numpy()

    with timer.stage("host_preprocess"):
        ride = build_ride_pieces(rot_times_usec, rot_rates, acc_times_usec, accelerations,
                                 gps_times_usec)
        num_gps = np.asarray(gps_times_usec).shape[0]
        lo, hi, starts, pmax = build_window_index(
            ride, gps_times_usec, config.locations_batch_size, config.locations_shift_step)

    with timer.stage("solve_and_reduce"):
        sol, ev_sum, ev_count, forward_total = _solve_and_reduce(
            put(ride.piece_rot_rates), put(ride.piece_accelerations), put(ride.piece_dt_sec),
            put(ride.piece_gps_end_index, torch.int64), put(ride.piece_event_index, torch.int64),
            put(ride.piece_next_event_differs, torch.bool), put(gps_speeds),
            put(lo, torch.int64), put(hi, torch.int64), put(starts, torch.int64),
            num_gps=num_gps, max_pieces=pmax, batch_size=config.locations_batch_size,
            num_events=ride.num_events, num_iters=config.optimization_iters,
            min_velocity=float(config.forward_axis_inference_min_velocity_m_s),
            min_rotation_rad=float(config.forward_axis_inference_min_rotation_rad),
            mesh=mesh,
        )
        ev_sum = ev_sum.cpu().numpy()
        ev_count = ev_count.cpu().numpy()

    with timer.stage("smooth_and_assemble"):
        result = assemble_result(
            ride, rot_times_usec, vertical.cpu().numpy(), steering,
            sol.x.cpu().numpy().astype(np.float64), sol.loss.cpu().numpy().astype(np.float64),
            ev_sum, ev_count, forward_total.cpu().numpy().astype(np.float64), config,
        )
    return result


def assemble_result(ride, rot_times_usec, vertical, steering, window_params, window_loss,
                    ev_sum, ev_count, forward_total, config: FitMotionConfig) -> FitMotionResult:
    """Host post-processing: covered-event averaging, Gaussian
    post-smoothing (on the config's device), and the forward axis's
    orthogonalization and normalization."""
    covered = ev_count > 0
    avg_speeds = ev_sum[covered] / ev_count[covered]
    out_times = ride.event_times_usec[covered]
    if out_times.size:
        t_sec = (out_times - out_times[0]).astype(np.float64) * 1e-6
        smoothed = smooth_time_series(avg_speeds, t_sec, t_sec, config.post_smoothing_sigma_sec,
                                      dtype=config.dtype, device=config.device).cpu().numpy()
    else:
        smoothed = avg_speeds

    forward = np.asarray(forward_total, np.float64)
    vert = np.asarray(vertical, np.float64)
    forward = forward - vert * float(vert @ forward)
    forward = forward / (np.linalg.norm(forward) + 1e-5)
    return FitMotionResult(
        vertical_axis=vert,
        steering_times_usec=np.asarray(rot_times_usec, np.int64),
        steering_angular_velocities=np.asarray(steering, np.float64),
        velocity_times_usec=out_times,
        velocities_m_s=smoothed,
        forward_axis=forward,
        window_params=window_params,
        window_final_loss=window_loss,
    )


def window_loss_fn(problem: WindowedProblem, window: int, dtype=torch.float64):
    """The reference-normalized loss of one window (sum of squared residuals
    over the window's total time), as a function of its 9 parameters, on
    the CPU: for the oracle tests."""

    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a), dtype=kind)

    def loss(params):
        r = window_residuals(
            put(params), put(problem.rot_rates[window]), put(problem.accelerations[window]),
            put(problem.dt_sec[window]), put(problem.segment_ids[window], torch.int64),
            put(problem.gps_speeds[window]), problem.num_segments,
        )
        return (r * r).sum() / put(problem.dt_sec[window]).sum()

    return loss
