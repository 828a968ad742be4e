"""Time-weighted interval averages of a sampled series, for all query
intervals at once (port of pilotguru_tpu/timeseries/interval_average.py).

The reference averages, per query interval [t0, t1], the piecewise-linear
interpolant of the series over the interval, summing whole-interval
trapezoids plus the interpolated partial end intervals
(TimeSeries::TimeAveragedValue, include/interpolation/time_series.hpp:
134-189). That is (F(t1) - F(t0)) / (t1 - t0), F the cumulative
trapezoidal integral of the interpolant: one search, one gather and fused
arithmetic over all intervals. annotate_frames (src/annotate_frames.cc:
56-68) averages a series between consecutive video frames this way.

The interval indices come from a search on the int64 microsecond times
(the JAX package searches float64 seconds, which hold microseconds
exactly, so the indices are the same); in float32 a search in seconds
could move a boundary where a frame and a sample coincide late in a long
ride. Only the interpolation weights and sums are computed in the float
dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def blocked_cumsum(x: torch.Tensor, block: int = 16, dim: int = 0) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in the order of XLA's CPU
    cumsum (the JAX package's ``jnp.cumsum``, which made the goldens):
    left to right within blocks of 16, the blocks' totals summed the same
    way recursively, and each block's running sums then offset by the
    total of the blocks before it. The same float sums, so the same bits,
    on any device (CUDA's own float32 cumsum along a strided axis drifts
    far more): about 16 launches a level, log16(N) levels."""
    if dim != 0:
        return blocked_cumsum(x.movedim(dim, 0), block).movedim(0, dim)
    n, rest = x.shape[0], x.shape[1:]
    rows = -(-n // block)
    cols = torch.cat([x, x.new_zeros((rows * block - n,) + rest)]).reshape((rows, block) + rest)
    running = [cols[:, 0]]
    for k in range(1, block):
        running.append(running[-1] + cols[:, k])
    inner = torch.stack(running, dim=1)  # [rows, block, ...]
    if rows > 1:
        before = blocked_cumsum(inner[:, -1], block)[:-1]
        inner = torch.cat([inner[:1], inner[1:] + before.unsqueeze(1)])
    return inner.reshape((-1,) + rest)[:n]


def time_averaged_values(values, times_usec, query_start_usec, query_end_usec,
                         dtype=torch.float64, device="cuda"):
    """Average the linear interpolant of (times, values) over query
    intervals, on ``device`` in ``dtype``.

    values [N] (array or tensor); times_usec [N] sorted int64 sample times
    (microseconds);
    query_start_usec, query_end_usec [Q] int64 interval bounds, start < end.
    Returns (averages [Q] tensor, garbage where invalid; valid [Q] bool
    tensor: the interval lies within the series, the reference's rule,
    time_series.hpp:142-145)."""
    times_np = np.asarray(times_usec, dtype=np.int64)
    q0_np = np.asarray(query_start_usec, dtype=np.int64)
    q1_np = np.asarray(query_end_usec, dtype=np.int64)
    n = times_np.shape[0]

    def put(a, kind=dtype):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=kind, device=device)

    # Seconds relative to the series start keep the float precision.
    t0 = int(times_np[0])
    ts = put((times_np - t0) * 1e-6)
    v = put(values)
    q0 = put((q0_np - t0) * 1e-6)
    q1 = put((q1_np - t0) * 1e-6)
    valid = put((q0_np >= times_np[0]) & (q1_np <= times_np[-1]), torch.bool)

    # Cumulative trapezoidal integral at the sample points.
    seg = 0.5 * (ts[1:] - ts[:-1]) * (v[1:] + v[:-1])
    cum = torch.cat([seg.new_zeros(1), blocked_cumsum(seg)])

    # The latest sample at or before each bound, clamped into [0, N-2].
    times_dev = put(times_np, torch.int64)

    def last_at_or_before(q_usec):
        j = torch.searchsorted(times_dev, put(q_usec, torch.int64), right=True) - 1
        return j.clamp(0, n - 2)

    def integral_at(j, t):
        frac = (t - ts[j]) / (ts[j + 1] - ts[j])
        v_t = v[j] + frac * (v[j + 1] - v[j])
        return cum[j] + 0.5 * (t - ts[j]) * (v[j] + v_t)

    total = integral_at(last_at_or_before(q1_np), q1) - integral_at(last_at_or_before(q0_np), q0)
    return total / (q1 - q0), valid


def annotate_frames_values(series_times_usec, series_values, frame_times_usec,
                           dtype=torch.float64, device="cuda"):
    """Frame i >= 1 gets the series averaged over [frame i-1, frame i]
    (annotate_frames.cc:57-68). Returns (values [F-1], valid [F-1]) tensors
    for frames 1..F-1; frames whose interval the series does not cover are
    invalid."""
    frame_times = np.asarray(frame_times_usec, dtype=np.int64)
    return time_averaged_values(series_values, series_times_usec, frame_times[:-1],
                                frame_times[1:], dtype=dtype, device=device)
