"""Which operations of fit_motion's window solve change their bits with the
number of windows in a call (PERF.md §6).

    python3 corpus_shard_ops.py [--device cuda|cpu] [--parts 2]

preprocess_corpus --shard_windows solves and replays each ride's windows
in blocks, one a device (calib/fit_motion.py::_solve_and_reduce). On
chip_smoke's first corpus ride (300 s, noise seed 0, 40 GPS fixes a
window every 5), each stage of the solve is computed on all windows at
once and on each of ``--parts`` contiguous blocks of them, from the same
inputs (the blocks are slices of the whole call's inputs), in float32 and
float64; the script prints each stage's largest difference between the two
(0 where equal to the bit): the delta quaternions and their scan, the
gyro-rotated accelerations, the cumulative sums along each axis, the
segment sums, the affine travel, the gravity start, the residual
Jacobian, the normal equations, their solve, the whole solve and the
replay.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import chip_smoke
from pilotguru_tpu_torch.calib import accelerometer as acc
from pilotguru_tpu_torch.calib import fit_motion
from pilotguru_tpu_torch.calib.pieces import build_ride_pieces
from pilotguru_tpu_torch.geometry import quaternion as quat
from pilotguru_tpu_torch.geometry.strapdown import integrate_motion
from pilotguru_tpu_torch.parallel.mesh import block_bounds

BATCH, SHIFT, ITERS = 40, 5, 30


def ride_windows(arrays, dtype, device):
    """The five window arrays _solve_and_reduce gives its solve (rotation
    rates, accelerations, durations, segment ids, GPS speeds), captured
    from one fit_motion run over the ride."""
    rot_t, rates, acc_t, accs, gps_t, gps = arrays
    ride = build_ride_pieces(rot_t, rates, acc_t, accs, gps_t)
    lo, hi, starts, pmax = fit_motion.build_window_index(ride, gps_t, BATCH, SHIFT)

    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    captured = {}
    real = fit_motion._solve_and_replay

    def capture(*args):
        captured["windows"] = args[:5]
        return real(*args)

    fit_motion._solve_and_replay = capture
    try:
        fit_motion._solve_and_reduce(
            put(ride.piece_rot_rates), put(ride.piece_accelerations), put(ride.piece_dt_sec),
            put(ride.piece_gps_end_index, torch.int64), put(ride.piece_event_index, torch.int64),
            put(ride.piece_next_event_differs, torch.bool), put(gps), put(lo, torch.int64),
            put(hi, torch.int64), put(starts, torch.int64), num_gps=len(gps_t),
            max_pieces=pmax, batch_size=BATCH, num_events=ride.num_events, num_iters=ITERS,
            min_velocity=5.0, min_rotation_rad=0.2)
    finally:
        fit_motion._solve_and_replay = real
    return captured["windows"]


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else [t for v in x for t in _leaves(v)]


def block_difference(fn, parts, *args) -> float:
    """The largest difference between fn over all windows (the leading
    axis of every argument) and fn over each block, on the block's rows."""
    whole = _leaves(fn(*args))
    worst = 0.0
    for lo, hi in block_bounds(args[0].shape[0], parts):
        for w, b in zip(whole, _leaves(fn(*[a[lo:hi] for a in args]))):
            if w.is_floating_point():
                worst = max(worst, (w[lo:hi].double() - b.double()).abs().max().item())
            else:
                worst = max(worst, float((w[lo:hi] != b).sum().item()))
    return worst


def stage_differences(windows, parts) -> dict:
    rr, aa, dt, seg, gw = windows
    segments = BATCH
    q_post = quat.quat_cumulative_product(quat.rotation_rate_to_quat(rr, dt))
    r_pre = quat.quat_to_rotation_matrix(q_post)
    a, c, ref = acc.precompute_affine_travel(rr, aa, dt, seg, gw, segments)
    starts = (acc.gravity_init(rr, aa, dt)[:, None, :].expand(-1, 10, -1) + 0.01).contiguous()
    a, c, ref = a[:, None], c[:, None], ref[:, None]
    jac, r = acc.affine_window_jacobian(starts, a, c, ref)
    jt = jac.transpose(-1, -2)
    normal = jt @ jac + 1e-3 * torch.eye(9, dtype=jac.dtype, device=jac.device)
    rhs = (jt @ r[..., None])[..., 0]
    sol = acc.solve_windows(rr, aa, dt, seg, gw, segments, num_iters=ITERS)
    stages = {
        "delta quaternions and their scan": (
            lambda r_, d_: quat.quat_cumulative_product(quat.rotation_rate_to_quat(r_, d_)),
            rr, dt),
        "r_pre @ accelerations (batched 3x3 products)": (
            lambda m_, v_: (m_ @ v_[..., None])[..., 0], r_pre, aa),
        "cumsum along the pieces (dim -2)": (
            lambda d_, x_: torch.cumsum(d_[..., None] * x_, dim=-2), dt, aa),
        "cumsum of rotations (dim -3)": (
            lambda d_, x_: torch.cumsum(d_[..., None, None] * x_, dim=-3), dt, r_pre),
        "cumsum of durations (innermost dim)": (lambda d_: torch.cumsum(d_, dim=-1), dt),
        "segment_sum": (lambda x_, s_: acc.segment_sum(x_, s_, segments), aa, seg),
        "precompute_affine_travel": (
            lambda *w: acc.precompute_affine_travel(*w, segments), rr, aa, dt, seg, gw),
        "gravity_init": (acc.gravity_init, rr, aa, dt),
        "affine_window_jacobian (broadcast products)": (
            acc.affine_window_jacobian, starts, a, c, ref),
        "jt @ jac": (lambda x_, y_: x_ @ y_, jt, jac),
        "jt @ r": (lambda x_, y_: (x_ @ y_[..., None])[..., 0], jt, r),
        "linalg.solve_ex (9x9)": (lambda m_, b_: torch.linalg.solve_ex(m_, b_)[0], normal, rhs),
        "solve_windows (the whole solve)": (
            lambda *w: acc.solve_windows(*w, segments, num_iters=ITERS), rr, aa, dt, seg, gw),
        "integrate_motion (the replay)": (
            lambda r_, a_, d_, x_: integrate_motion(r_, a_, d_, x_[:, 0:3], x_[:, 3:6],
                                                    x_[:, 6:9]), rr, aa, dt, sol.x),
    }
    return {name: block_difference(fn, parts, *args) for name, (fn, *args) in stages.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--parts", type=int, default=2)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("corpus_shard_ops.py: no CUDA device (use --device cpu)")
        print(f"card: {chip_smoke.card_name_and_power()}", flush=True)
    arrays, _ = chip_smoke.make_imu_ride(chip_smoke.CORPUS["ride_s"], seed=0)
    for dtype in (torch.float32, torch.float64):
        windows = ride_windows(arrays, dtype, args.device)
        row = {"device": args.device, "dtype": str(dtype).split(".")[-1],
               "windows": windows[0].shape[0], "pieces_per_window": windows[0].shape[1],
               "parts": args.parts, "largest_difference": stage_differences(windows, args.parts)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
