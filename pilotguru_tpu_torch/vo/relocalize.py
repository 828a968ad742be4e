"""Relocalization: recover the camera pose from scratch against the map
(port of pilotguru_tpu/vo/relocalize.py).

One exhaustive Hamming match against all map-point descriptors, a fixed
batch of 6-point DLT pose hypotheses (RANSAC), and the robust pose
optimizer on the best one. Hypothesis samples can be injected (``samples``)
or are drawn from a CPU ``torch.Generator`` (see vo/twoview.draw_samples).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pilotguru_tpu_torch.utils import linalg
from pilotguru_tpu_torch.vo import matching
from pilotguru_tpu_torch.vo.pose import (
    matrix_to_rotvec,
    optimize_pose,
    project,
    transform,
)
from pilotguru_tpu_torch.vo.twoview import draw_samples


class RelocalizationResult(NamedTuple):
    pose6: torch.Tensor  # [6]
    inliers: torch.Tensor  # [M] over map points
    num_inliers: torch.Tensor  # []
    observations: torch.Tensor  # [M, 2] matched normalized coords
    matched: torch.Tensor  # [M] bool


def dlt_pose(points3d, obs, weights):
    """Weighted DLT estimates of [R|t] from 2D-3D correspondences.

    points3d [..., n, 3], obs [..., n, 2], weights [..., n] -> pose6 [..., 6].
    The 3x3 block is scaled to unit determinant, projected onto SO(3), and
    the translation scaled with it."""
    xh = torch.cat([points3d, torch.ones_like(points3d[..., :1])], dim=-1)
    zeros = torch.zeros_like(xh)
    u = obs[..., 0:1]
    v = obs[..., 1:2]
    w = weights[..., None]
    rows_u = torch.cat([xh, zeros, -u * xh], dim=-1) * w  # [..., n, 12]
    rows_v = torch.cat([zeros, xh, -v * xh], dim=-1) * w
    a = torch.cat([rows_u, rows_v], dim=-2)
    _, _, vt = linalg.svd(a, full_matrices=False)
    p = vt[..., -1, :].reshape(a.shape[:-2] + (3, 4))
    m = p[..., :3]
    det = torch.linalg.det(m)
    sign = torch.sign(det + 1e-30)
    scale = sign / (det.abs() ** (1.0 / 3.0) + 1e-30)
    m = m * scale[..., None, None]
    t = p[..., 3] * scale[..., None]
    um, _, vmt = linalg.svd(m)
    r = um @ vmt
    r = r * torch.sign(torch.linalg.det(r))[..., None, None]
    return torch.cat([matrix_to_rotvec(r), t], dim=-1)


def relocalize(
    map_points,  # [M, 3]
    map_desc,  # [M, 256] uint8
    map_valid,  # [M] bool
    kp_norm,  # [K, 2]
    kp_desc,  # [K, 256] uint8
    kp_valid,  # [K] bool
    samples=None,  # optional [num_hypotheses, 6] map-point indices
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 64,
    inlier_threshold: float = 0.01,
) -> RelocalizationResult:
    """Global match + batched-RANSAC DLT + robust pose polish."""
    m = matching.match_descriptors(
        map_desc, kp_desc, valid_a=map_valid, valid_b=kp_valid,
        max_distance=matching.HAMMING_LOW, ratio=0.8,
    )
    matched = m.valid
    dtype = map_points.dtype
    obs = torch.where(
        matched[:, None], kp_norm[m.index.clamp_min(0).long()].to(dtype),
        torch.zeros((), dtype=dtype, device=map_points.device),
    )
    if samples is None:
        samples = draw_samples(matched.to(dtype) + 1e-9, num_hypotheses, 6, generator)
    samples = samples.to(device=map_points.device, dtype=torch.int64)

    poses = dlt_pose(map_points[samples], obs[samples], matched[samples].to(dtype))
    cam = transform(poses, map_points)  # [H, M, 3]
    err = torch.linalg.vector_norm(project(cam) - obs, dim=-1)
    good = matched & (err < inlier_threshold) & (cam[..., 2] > 0)
    best = torch.argmax(good.sum(-1))
    result = optimize_pose(poses[best], map_points, obs, matched)
    return RelocalizationResult(
        result.pose6, result.inliers, result.num_inliers, obs, matched
    )
