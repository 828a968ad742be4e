"""Gaussian smoothing of time series and of quaternion sequences (port of
pilotguru_tpu/timeseries/smoothing.py).

``smooth_time_series`` smooths a piecewise-constant series by integrating
it against a Gaussian centred at each target time (the reference's
SmoothTimeSeries, which walks a +-3 sigma window with two pointers). The
closed form, with band [left_t, right_t] around target t:

  out[t] = sum_{j=left}^{right-1} v[j] * (Phi(mid_{j,j+1}; t) - Phi(mid_{j-1,j}; t))
           + v[right] * (1 - Phi(mid_{right-1,right}; t))

with Phi the normal CDF and mid the midpoint between consecutive sample
times. The band bounds come from searchsorted on the host (the pointer walk
for sorted targets); the weighted gather-sum is one [T, B] tensor program,
B the widest band.
"""

from __future__ import annotations

import numpy as np
import torch

from pilotguru_tpu_torch.utils.fma import fma


def _band_bounds(timestamps: np.ndarray, targets: np.ndarray, sigma: float):
    """Per-target inclusive band [left, right] exactly as the pointer walk."""
    n = timestamps.shape[0]
    left = np.searchsorted(timestamps, targets - 3.0 * sigma, side="left") - 1
    left = np.clip(left, 0, n - 1)
    right = np.searchsorted(timestamps, targets + 3.0 * sigma, side="left")
    right = np.clip(right, 0, n - 1)
    return left.astype(np.int64), right.astype(np.int64)


def smooth_time_series(values, timestamps, target_timestamps, sigma: float,
                       dtype=torch.float64, *, device):
    """Gaussian smoothing of a (possibly vector-valued) time series.

    values [N] or [N, D]; timestamps [N] and target_timestamps [T] sorted,
    in the units of sigma (host arrays). The smoothing runs on ``device`` in
    ``dtype``; returns a [T] (or [T, D]) tensor there."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    values_np = np.asarray(values)
    ts_np = np.asarray(timestamps, dtype=np.float64)
    targets_np = np.asarray(target_timestamps, dtype=np.float64)
    if ts_np.shape[0] != values_np.shape[0]:
        raise ValueError("timestamps/values length mismatch")
    left, right = _band_bounds(ts_np, targets_np, float(sigma))
    band = int(np.max(right - left)) + 1 if targets_np.size else 1
    vals2d = values_np.reshape(values_np.shape[0], -1)

    def put(a, kind=dtype):
        return torch.as_tensor(a, dtype=kind, device=device)

    out = _smooth_banded(put(vals2d), put(ts_np), put(targets_np), put(left, torch.int64),
                         put(right, torch.int64), band, float(sigma))
    return out[:, 0] if values_np.ndim == 1 else out


def _smooth_banded(vals, ts, targets, left, right, band: int, sigma: float):
    n = ts.shape[0]
    j = torch.arange(band, device=ts.device)  # [B]
    idx = (left[:, None] + j[None, :]).clamp(0, n - 1)  # [T, B]
    m = (right - left)[:, None]  # number of intervals in each band
    g_ts = ts[idx]  # [T, B]
    g_vals = vals[idx]  # [T, B, D]
    # Midpoints between consecutive in-band samples; CDF at each midpoint.
    mid = 0.5 * (g_ts[:, :-1] + g_ts[:, 1:])  # [T, B-1]
    z = (mid - targets[:, None]) / (torch.sqrt(vals.new_tensor(2.0)) * sigma)
    cdf = 0.5 * (1.0 + torch.special.erf(z))
    # Midpoint CDFs apply to the m real intervals (j < m); positions at or
    # after the band's right edge take CDF = 1, so the remaining tail mass
    # lands on the right-edge sample and out-of-band weights vanish.
    cdf = torch.where(j[None, :-1] < m, cdf, 1.0)
    cdf_full = torch.cat([cdf.new_zeros(cdf.shape[0], 1), cdf,
                          cdf.new_ones(cdf.shape[0], 1)], dim=1)  # [T, B+1]
    weights = cdf_full[:, 1:] - cdf_full[:, :-1]  # [T, B]
    return torch.einsum("tb,tbd->td", weights, g_vals)


def smooth_quaternion_sequence(quats, sigma: int, dtype=torch.float64, *, device):
    """Per-component Gaussian filtering of a quaternion sequence + renorm.

    Matches SmoothHeadingDirections (reference src/slam/smoothing.cc:8-46):
    a discrete Gaussian kernel of size 4*sigma+1 applied per component with
    replicate border handling, then per-element renormalization. sigma is in
    samples. quats: [N, 4] array or tensor; returns a [N, 4] tensor on
    ``device``, computed there in ``dtype``."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    q = torch.as_tensor(np.asarray(quats), dtype=dtype, device=device)
    ksize = 4 * int(sigma) + 1
    half = ksize // 2
    x = np.arange(ksize, dtype=np.float64) - half
    kernel = np.exp(-(x**2) / (2.0 * float(sigma) ** 2))
    kernel = torch.as_tensor(kernel / kernel.sum(), dtype=dtype, device=device)
    padded = torch.cat([q[:1].expand(half, 4), q, q[-1:].expand(half, 4)])
    # The kernel is symmetric, so correlation equals convolution. The taps
    # accumulate in order, one fused multiply-add each, and the norm sums
    # the squares left to right with fused multiply-adds: the order and
    # rounding of XLA's CPU convolution and reduction (the JAX package's),
    # so the result matches the reference's to the bit.
    n = q.shape[0]
    smoothed = torch.zeros_like(q)
    for t in range(ksize):
        smoothed = fma(kernel[t], padded[t:t + n], smoothed)
    cols = smoothed.T
    sum_sq = cols[0] * cols[0]
    for k in range(1, 4):
        sum_sq = fma(cols[k], cols[k], sum_sq)
    norm = torch.sqrt(sum_sq)
    return smoothed / norm[:, None]
