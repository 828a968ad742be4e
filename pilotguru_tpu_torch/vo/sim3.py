"""Sim(3) algebra and weighted Umeyama alignment for monocular loop closing
(port of pilotguru_tpu/vo/sim3.py).

A Sim(3) element is a 7-vector [rotvec(3), t(3), log_s(1)] acting on points
as x -> exp(log_s) R x + t. Every function takes leading batch dimensions
(``[..., 7]``), which stand in for the reference's vmaps. The RANSAC wrapper
takes its hypothesis samples as an argument (``samples``, as
vo/twoview.py and vo/relocalize.py do), else draws them from a CPU
``torch.Generator``: the reference's ``jax.random`` draws cannot be
reproduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pilotguru_tpu_torch.utils import linalg
from pilotguru_tpu_torch.vo.pose import matrix_to_rotvec, rotvec_to_matrix
from pilotguru_tpu_torch.vo.twoview import draw_samples


def identity(dtype=torch.float64, device=None):
    return torch.zeros(7, dtype=dtype, device=device)


def from_pose6(pose6):
    """Lift an SE(3) 6-vector to Sim(3) with unit scale."""
    return torch.cat([pose6, torch.zeros_like(pose6[..., :1])], dim=-1)


def to_pose6(sim7):
    """Project Sim(3) back to SE(3): [R, t, s] -> [R, t/s] (LoopClosing.cc:
    eigt *= (1./s))."""
    s = torch.exp(sim7[..., 6:7])
    return torch.cat([sim7[..., :3], sim7[..., 3:6] / s], dim=-1)


def _apply(r, v):
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return (r @ v[..., None])[..., 0]


def act(sim7, points):
    """Apply x -> s R x + t to [..., 3] points (batch dims broadcast)."""
    r = rotvec_to_matrix(sim7[..., :3])
    s = torch.exp(sim7[..., 6])
    return s[..., None] * _apply(r, points) + sim7[..., 3:6]


def compose(a, b):
    """(a o b)(x) = a(b(x)) = (s_a s_b)(R_a R_b) x + s_a R_a t_b + t_a."""
    ra = rotvec_to_matrix(a[..., :3])
    rb = rotvec_to_matrix(b[..., :3])
    sa = torch.exp(a[..., 6])
    rot = matrix_to_rotvec(ra @ rb)
    t = sa[..., None] * _apply(ra, b[..., 3:6]) + a[..., 3:6]
    return torch.cat([rot, t, (a[..., 6] + b[..., 6])[..., None]], dim=-1)


def inverse(a):
    """x -> (1/s) R^T (x - t)."""
    rt = rotvec_to_matrix(a[..., :3]).transpose(-1, -2)
    s = torch.exp(a[..., 6])
    rot = matrix_to_rotvec(rt)
    t = -_apply(rt, a[..., 3:6] / s[..., None])
    return torch.cat([rot, t, -a[..., 6:7]], dim=-1)


def error_vector(a, b):
    """7-vector local error (zero iff a == b): [rotvec(Ra Rb^T), ta - tb,
    log(sa/sb)], exact in rotation and scale, linear in translation."""
    ra = rotvec_to_matrix(a[..., :3])
    rb = rotvec_to_matrix(b[..., :3])
    rot_err = matrix_to_rotvec(ra @ rb.transpose(-1, -2))
    return torch.cat(
        [rot_err, a[..., 3:6] - b[..., 3:6], (a[..., 6] - b[..., 6])[..., None]], dim=-1
    )


class UmeyamaResult(NamedTuple):
    sim7: torch.Tensor  # [..., 7] maps A-frame points into the B frame
    valid: torch.Tensor  # [...] bool: enough spread to be well-posed


def umeyama_sim3(points_a, points_b, weights) -> UmeyamaResult:
    """Weighted scaled orthogonal Procrustes (Umeyama 1991, closed form):
    s, R, t minimising sum_i w_i ||b_i - (s R a_i + t)||^2. points [..., N, 3],
    weights [..., N]."""
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-12)
    mu_a = (points_a * w[..., None]).sum(-2)
    mu_b = (points_b * w[..., None]).sum(-2)
    ca = points_a - mu_a[..., None, :]
    cb = points_b - mu_b[..., None, :]
    cov = (cb * w[..., None]).transpose(-1, -2) @ ca  # sum w (b-mub)(a-mua)^T
    u, sv, vt = linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    r = (u * diag[..., None, :]) @ vt
    var_a = (w * (ca * ca).sum(-1)).sum(-1)
    scale = (sv * diag).sum(-1) / var_a.clamp_min(1e-12)
    t = mu_b - scale[..., None] * _apply(r, mu_a)
    log_s = torch.log(scale.clamp_min(1e-12))
    sim7 = torch.cat([matrix_to_rotvec(r), t, log_s[..., None]], dim=-1)
    # Degenerate when the source points are (near-)collinear: the second
    # singular value collapses relative to the first.
    valid = (sv[..., 1] > 1e-9 * sv[..., 0].clamp_min(1e-30)) & (var_a > 1e-12)
    return UmeyamaResult(sim7, valid)


class Sim3RansacResult(NamedTuple):
    sim7: torch.Tensor  # [7]
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # []


def ransac_umeyama(
    points_a,  # [N, 3]
    points_b,  # [N, 3]
    valid,  # [N] bool
    samples=None,  # optional [num_hypotheses, 3] indices
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 64,
    inlier_threshold: float = 0.05,
) -> Sim3RansacResult:
    """Fixed-count RANSAC over 3-point Umeyama solves, polished with one
    weighted solve on the winner's inliers (Sim3Solver::iterate semantics).

    ``inlier_threshold`` is relative: a correspondence is an inlier when its
    alignment residual is below threshold x the RMS spread of the B points
    (monocular point clouds have an arbitrary scale). Hypotheses draw 3
    valid correspondences without replacement (``samples``, else the CPU
    ``generator``)."""
    w = valid.to(points_a.dtype)
    total = w.sum().clamp_min(1e-12)
    centre = (points_b * w[:, None]).sum(0) / total
    spread = torch.sqrt((w * ((points_b - centre) ** 2).sum(1)).sum() / total)
    threshold = inlier_threshold * spread.clamp_min(1e-9)

    if samples is None:
        samples = draw_samples(w, num_hypotheses, 3, generator)
    samples = samples.to(device=points_a.device, dtype=torch.int64)
    fits = umeyama_sim3(points_a[samples], points_b[samples], w[samples] + 1e-9)
    err = torch.linalg.vector_norm(
        act(fits.sim7[:, None, :], points_a[None]) - points_b[None], dim=-1
    )  # [H, N]
    good = valid[None] & (err < threshold) & fits.valid[:, None]
    best = torch.argmax(good.sum(1))

    # Polish: weighted Umeyama on the winning hypothesis' inliers.
    err0 = torch.linalg.vector_norm(act(fits.sim7[best], points_a) - points_b, dim=-1)
    good0 = valid & (err0 < threshold)
    polish = umeyama_sim3(points_a, points_b, good0.to(points_a.dtype) + 1e-12)
    err = torch.linalg.vector_norm(act(polish.sim7, points_a) - points_b, dim=-1)
    inliers = valid & (err < threshold)
    return Sim3RansacResult(polish.sim7, inliers, inliers.sum())
