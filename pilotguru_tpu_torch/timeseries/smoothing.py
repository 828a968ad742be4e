"""Quaternion-sequence smoothing (port of
pilotguru_tpu/timeseries/smoothing.py::smooth_quaternion_sequence)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def smooth_quaternion_sequence(quats, sigma: int, dtype=torch.float64):
    """Per-component Gaussian filtering of a quaternion sequence + renorm.

    Matches SmoothHeadingDirections (reference src/slam/smoothing.cc:8-46):
    a discrete Gaussian kernel of size 4*sigma+1 applied per component with
    replicate border handling, then per-element renormalization. sigma is in
    samples. quats: [N, 4] array or tensor; returns a [N, 4] tensor."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    q = torch.as_tensor(np.asarray(quats), dtype=dtype)
    ksize = 4 * int(sigma) + 1
    half = ksize // 2
    x = np.arange(ksize, dtype=np.float64) - half
    kernel = np.exp(-(x**2) / (2.0 * float(sigma) ** 2))
    kernel = torch.as_tensor(kernel / kernel.sum(), dtype=dtype)
    padded = torch.cat([q[:1].expand(half, 4), q, q[-1:].expand(half, 4)])
    # The kernel is symmetric, so correlation equals convolution.
    smoothed = F.conv1d(padded.T[:, None, :], kernel[None, None, :])[:, 0, :].T
    return smoothed / torch.linalg.vector_norm(smoothed, dim=1, keepdim=True)
