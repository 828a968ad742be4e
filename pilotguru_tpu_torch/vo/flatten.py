"""Horizontal-plane flattening of visual-odometry trajectories (port of
pilotguru_tpu/vo/flatten.py; reference src/slam/horizontal_flatten.cc and
the PCA + validity test of src/slam/track_image_sequence.cc:16-29, 72-94).
Host-side post-processing of one segment, in float64."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pilotguru_tpu_torch.geometry.quaternion import quat_rotate


def trajectory_pca(translations) -> Tuple[np.ndarray, np.ndarray]:
    """PCA of trajectory translations (TrajectoryToPCA): (eigenvectors
    [3, 3] rows in descending-eigenvalue order, eigenvalues [3]); each row's
    largest-|component| is made positive."""
    t = np.asarray(translations, np.float64)
    centered = t - t.mean(axis=0, keepdims=True)
    cov = centered.T @ centered / t.shape[0]
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1]
    axes = eigvecs[:, order].T
    dominant = np.take_along_axis(
        axes, np.argmax(np.abs(axes), axis=1)[:, None], axis=1
    )
    return axes * np.sign(dominant), eigvals[order]


def plane_is_valid(eigenvalues, relative_tolerance: float = 1e-2) -> bool:
    """Reject when the 3rd eigenvalue exceeds 1e-2 x the 2nd
    (track_image_sequence.cc:85-92)."""
    return bool(eigenvalues[2] <= eigenvalues[1] * relative_tolerance)


def project_directions(rotations, plane) -> np.ndarray:
    """Camera optical axes (+z rotated by each pose) projected onto the 2x3
    plane (ProjectDirections, horizontal_flatten.cc:7-29). Returns [N, 2]."""
    q = torch.as_tensor(np.asarray(rotations, np.float64))
    z = torch.tensor([0.0, 0.0, 1.0], dtype=q.dtype).expand(q.shape[:-1] + (3,))
    dirs = quat_rotate(q, z)
    return (dirs @ torch.as_tensor(np.asarray(plane, np.float64)).T).numpy()


def turn_angles_from_directions(directions) -> np.ndarray:
    """Signed angles between consecutive 2-D directions
    (Projected2DDirectionsToTurnAngles, horizontal_flatten.cc:44-64):
    acos of the normalized dot, sign + only for a strictly positive cross.
    Element 0 is 0."""
    d = np.asarray(directions, np.float64)
    prev, curr = d[:-1], d[1:]
    dot = np.sum(prev * curr, axis=1)
    norms = np.linalg.norm(prev, axis=1) * np.linalg.norm(curr, axis=1)
    cos = np.clip(dot / norms, -1.0, 1.0)
    cross = prev[:, 0] * curr[:, 1] - prev[:, 1] * curr[:, 0]
    angles = np.arccos(cos) * np.where(cross > 0, 1.0, -1.0)
    return np.concatenate([[0.0], angles])


def flatten_trajectory(trajectory, relative_tolerance: float = 1e-2):
    """(plane [2, 3], directions [N, 2], turn_angles [N]) for one
    trajectory, or None when the flatness test fails."""
    axes, eigvals = trajectory_pca(trajectory.translations)
    if not plane_is_valid(eigvals, relative_tolerance):
        return None
    plane = axes[:2]
    directions = project_directions(trajectory.rotations, plane)
    return plane, directions, turn_angles_from_directions(directions)
