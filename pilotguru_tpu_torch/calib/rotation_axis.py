"""Principal rotation axis (vehicle vertical) and axis-projected steering
(port of pilotguru_tpu/calib/rotation_axis.py).

The gyro stream is integrated into >= 0.5 s quaternion chunks; PCA over
the chunks' (x, y, z) components gives the dominant rotation axis, taken
as vertical because steering rotations dominate. Projecting the raw angular
velocities onto it gives the steering signal. Chunk boundaries are a greedy
host computation; the chunks' quaternion products are one padded log-depth
scan over [C, Lmax, 4]; the 3x3 PCA is an eigendecomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from pilotguru_tpu_torch.geometry.quaternion import (
    quat_cumulative_product,
    rotation_rate_to_quat,
)


def chunk_boundaries(times_usec: np.ndarray, interval_usec: int) -> np.ndarray:
    """Greedy chunking: accumulate step durations, emit when >= interval.

    Steps are (t[i-1], t[i]] for i >= 1; a chunk closes at the first step
    where the accumulated duration reaches ``interval_usec``. Returns chunk
    end indices (inclusive, into ``times_usec``); steps after the last chunk
    are dropped, like the reference."""
    times = np.asarray(times_usec, np.int64)
    ends = []
    start = 0
    n = times.shape[0]
    while True:
        # First i > start with times[i] - times[start] >= interval.
        i = int(np.searchsorted(times, times[start] + interval_usec, side="left"))
        if i >= n:
            break
        ends.append(i)
        start = i
    return np.asarray(ends, np.int64)


def integrate_rotation_chunks(times_usec, rot_rates, interval_usec: int,
                              dtype=torch.float64, *, device):
    """Per-chunk integrated quaternions [C, 4] on ``device``: each chunk's
    ordered product of per-step delta quaternions."""
    times = np.asarray(times_usec, np.int64)
    rates = np.asarray(rot_rates, np.float64)
    ends = chunk_boundaries(times, int(interval_usec))
    if ends.size < 3:
        raise ValueError(
            "need at least 3 rotation chunks for PCA "
            f"(got {ends.size}); ride too short for axis inference"
        )
    starts = np.concatenate([[0], ends[:-1]])
    lmax = int(np.max(ends - starts))
    # Step j of chunk c is (idx-1, idx] with idx = starts[c] + 1 + j, valid
    # while idx <= ends[c]; padded steps integrate to the identity.
    idx = starts[:, None] + 1 + np.arange(lmax, dtype=np.int64)[None, :]  # [C, L]
    valid = idx <= ends[:, None]
    idx_c = np.minimum(idx, times.shape[0] - 1)
    step_rates = np.where(valid[..., None], rates[idx_c], 0.0)
    step_dt = np.where(valid, (times[idx_c] - times[idx_c - 1]) * 1e-6, 0.0)
    return _chunk_quats(torch.as_tensor(step_rates, dtype=dtype, device=device),
                        torch.as_tensor(step_dt, dtype=dtype, device=device))


def _chunk_quats(step_rates, step_dt):
    """Ordered per-chunk quaternion products [C, 4] from padded steps
    [C, L, 3] and [C, L]: one batched scan; padded steps give the identity,
    so only each chunk's last scan element matters."""
    return quat_cumulative_product(rotation_rate_to_quat(step_rates, step_dt))[:, -1, :]


def principal_rotation_axes(times_usec, rot_rates, interval_usec: int = 500_000,
                            dtype=torch.float64, *, device):
    """PCA eigenvectors (rows, descending eigenvalue) of the chunk quaternions'
    (x, y, z), and the eigenvalues. Each axis's sign makes its
    largest-magnitude component positive; row 0 is the inferred vertical."""
    quats = integrate_rotation_chunks(times_usec, rot_rates, interval_usec, dtype,
                                      device=device)
    return _masked_pca(quats, torch.ones(quats.shape[0], dtype=torch.bool, device=device))


def _masked_pca(quats, mask):
    xyz = quats[:, 1:4]
    w = mask.to(xyz.dtype)[:, None]
    mean = (xyz * w).sum(dim=0, keepdim=True) / w.sum()
    centered = (xyz - mean) * w
    eigvals, eigvecs = torch.linalg.eigh(centered.T @ centered)  # ascending
    axes = eigvecs.flip(1).T  # rows, descending eigenvalue
    dominant = axes.gather(1, axes.abs().argmax(dim=1, keepdim=True))
    return axes * torch.sign(dominant), eigvals.flip(0)


def angular_velocities_around_axis(rot_rates, axis):
    """Raw gyro rates [N, 3] projected onto a (near-unit) axis [3]:
    <rate_i, axis> / ||axis||."""
    return rot_rates @ (axis / torch.linalg.vector_norm(axis))


def rotations_complementary_to_axis(rot_rates, axis):
    """Raw gyro rates [N, 3] with their component along ``axis`` [3]
    removed (GetRotationsComplementaryToAxisDirect, rotation.cc:121-146):
    rate_i - <rate_i, axis> axis / ||axis||^2."""
    norm = torch.linalg.vector_norm(axis)
    along = (rot_rates @ axis)[:, None] * axis[None, :] / (norm * norm)
    return rot_rates - along
