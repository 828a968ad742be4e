"""Two-view geometry: batched-RANSAC essential + homography models with H/F
selection, pose recovery and triangulation (port of pilotguru_tpu/vo/twoview.py).

RANSAC is a fixed batch of hypotheses: each draws 8 correspondences
(weighted by the match mask, without replacement); the essential matrix is
fit from all 8 and the homography from the first 4. The reference draws
them from ``jax.random`` keys, which torch cannot reproduce, so
``two_view_reconstruction`` takes an optional ``samples`` index array
(tests replay the reference's draws) and otherwise draws from a CPU
``torch.Generator`` (the same draws on every device). SVD signs differ
between LAPACK and cuSOLVER; every consumer is sign-invariant (errors,
cheirality votes, determinants).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pilotguru_tpu_torch.vo.pose import inv3x3


class TwoViewResult(NamedTuple):
    rotation: torch.Tensor  # [3, 3] camera1 -> camera2 (R21)
    translation: torch.Tensor  # [3] unit-norm t21
    points3d: torch.Tensor  # [N, 3] in camera-1 frame
    inliers: torch.Tensor  # [N] bool
    score: torch.Tensor  # [] inlier count of the winning pose


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _project_essential(e):
    """Project [..., 3, 3] onto the essential manifold: singular values (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(e)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=e.dtype, device=e.device)
    return (u * d) @ vt


def _essential_from_eight(p1, p2):
    """8-point essential matrices from [H, 8, 2] normalized correspondences."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    a = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )  # [H, 8, 9]
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :].reshape(a.shape[:-2] + (3, 3))
    return _project_essential(e)


def _sampson_error(e, p1, p2):
    """Sampson error of x2' E x1 = 0: e [..., 3, 3], p [N, 2] -> [..., N]."""
    x1 = _homogeneous(p1)
    x2 = _homogeneous(p2)
    ex1 = x1 @ e.transpose(-1, -2)  # rows (E x1)^T
    etx2 = x2 @ e  # rows (E^T x2)^T
    num = (x2 * ex1).sum(-1) ** 2
    den = ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    return num / (den + 1e-18)


def _homography_from_four(p1, p2):
    """DLT homographies from [H, 4, 2] normalized correspondences."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rows_b = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    a = torch.cat([rows_a, rows_b], dim=-2)  # [H, 8, 9]
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    return vt[..., -1, :].reshape(a.shape[:-2] + (3, 3))


def _homography_sym_error(h, p1, p2):
    """Symmetric transfer error of x2 ~ H x1: h [..., 3, 3] -> [..., N]."""

    def transfer(mat, a, b):
        y = _homogeneous(a) @ mat.transpose(-1, -2)
        w = y[..., 2]
        w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        proj = y[..., :2] / w[..., None]
        err = ((proj - b) ** 2).sum(-1)
        return torch.nan_to_num(err, nan=1e9, posinf=1e9)

    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    det = torch.linalg.det(h)
    safe = torch.where((det.abs() < 1e-12)[..., None, None], h + 1e-6 * eye, h)
    hinv = torch.linalg.inv_ex(safe)[0]
    return transfer(h, p1, p2) + transfer(hinv, p2, p1)


def decompose_homography(h):
    """Faugeras SVD decomposition of a Euclidean homography into its 8
    motion hypotheses (Initializer.cc ReconstructH): (rs [8, 3, 3],
    ts [8, 3] unit-norm)."""
    u, d, vt = torch.linalg.svd(h)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = torch.full((), 1e-12, dtype=h.dtype, device=h.device)

    denom13 = torch.maximum(d1 * d1 - d3 * d3, eps)
    x1 = torch.sqrt(((d1 * d1 - d2 * d2) / denom13).clamp_min(0.0))
    x3 = torch.sqrt(((d2 * d2 - d3 * d3) / denom13).clamp_min(0.0))
    x1s = torch.stack([x1, x1, -x1, -x1])
    x3s = torch.stack([x3, -x3, x3, -x3])
    zero = torch.zeros_like(x1s)
    one = torch.ones_like(x1s)

    def rot_y(c, sn, mid, last_sign):
        return torch.stack(
            [
                torch.stack([c, zero, -last_sign * sn], dim=-1),
                torch.stack([zero, mid, zero], dim=-1),
                torch.stack([sn, zero, last_sign * c], dim=-1),
            ],
            dim=-2,
        )

    # d' = +d2: sin = (d1 - d3) x1 x3 / d2, cos = (d2^2 + d1 d3) / ((d1 + d3) d2).
    c_pos = (d2 * d2 + d1 * d3) / torch.maximum((d1 + d3) * d2, eps)
    s_pos = (d1 - d3) * x1s * x3s / torch.maximum(d2, eps)
    rp_pos = rot_y(c_pos.expand(4), s_pos, one, 1.0)
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], dim=-1)

    # d' = -d2: R' = [[c, 0, s], [0, -1, 0], [s, 0, -c]],
    # sin = (d1 + d3) x1 x3 / d2, cos = (d1 d3 - d2^2) / ((d1 - d3) d2).
    den = (d1 - d3) * d2
    den_neg = torch.where(den.abs() < eps, eps, den)
    c_neg = (d1 * d3 - d2 * d2) / den_neg
    s_neg = (d1 + d3) * x1s * x3s / torch.maximum(d2, eps)
    rp_neg = rot_y(c_neg.expand(4), s_neg, -one, -1.0)
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], dim=-1)

    rp = torch.cat([rp_pos, rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    rs = s * (u @ rp @ vt)
    ts = tp @ u.T
    ts = ts / torch.maximum(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), eps)
    return rs, ts


def triangulate(r21, t21, p1, p2):
    """Closed-form linear triangulation in the camera-1 frame (the DLT rows
    with x4 = 1, solved through 3x3 normal equations). r21 [..., 3, 3],
    t21 [..., 3], p [N, 2] -> [..., N, 3]."""
    n = p1.shape[0]
    batch = r21.shape[:-2]
    zeros = torch.zeros(n, dtype=r21.dtype, device=r21.device)
    ones = torch.ones_like(zeros)
    row1 = torch.stack([-ones, zeros, p1[:, 0], zeros], dim=-1).expand(batch + (n, 4))
    row2 = torch.stack([zeros, -ones, p1[:, 1], zeros], dim=-1).expand(batch + (n, 4))
    pr2 = torch.cat([r21, t21[..., None]], dim=-1)  # [..., 3, 4]
    row3 = p2[:, 0, None] * pr2[..., 2:3, :] - pr2[..., 0:1, :]
    row4 = p2[:, 1, None] * pr2[..., 2:3, :] - pr2[..., 1:2, :]
    a = torch.stack([row1, row2, row3, row4], dim=-2)  # [..., N, 4, 4]
    b_mat = a[..., :3]
    rhs = -a[..., 3]
    g = b_mat.transpose(-1, -2) @ b_mat  # [..., N, 3, 3]
    h = (b_mat.transpose(-1, -2) @ rhs[..., None])[..., 0]  # [..., N, 3]
    return (inv3x3(g) @ h[..., None])[..., 0]


def _cheirality(r21, t21, p1, p2, mask):
    """Cheirality vote of poses [..., 3, 3]/[..., 3]: (counts, points, good)."""
    pts = triangulate(r21, t21, p1, p2)
    z1 = pts[..., 2]
    z2 = (pts @ r21.transpose(-1, -2) + t21[..., None, :])[..., 2]
    finite = torch.isfinite(pts).all(-1)
    good = (z1 > 0) & (z2 > 0) & (z1.abs() < 1e4) & finite & mask
    return good.sum(-1), pts, good


def _pick_best(rs, ts, p1, p2, mask):
    counts, points, goods = _cheirality(rs, ts, p1, p2, mask)
    best = torch.argmax(counts)
    return rs[best], ts[best], points[best], goods[best], counts[best]


def recover_pose(e, p1, p2, mask):
    """Decompose E into its 4 candidate poses and pick by cheirality vote."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)
    r_a = u @ w @ vt
    r_b = u @ w.T @ vt
    t = u[:, 2]
    rs = torch.stack([r_a, r_a, r_b, r_b])
    ts = torch.stack([t, -t, t, -t])
    return _pick_best(rs, ts, p1, p2, mask)


def recover_pose_homography(h, p1, p2, mask):
    """Pick the physical (R, t) among the 8 Faugeras hypotheses by
    cheirality vote."""
    rs, ts = decompose_homography(h)
    return _pick_best(rs, ts, p1, p2, mask)


def draw_samples(weights, num_hypotheses: int, sample_size: int,
                 generator: Optional[torch.Generator] = None):
    """[num_hypotheses, sample_size] int64 indices drawn without replacement
    with probabilities proportional to ``weights``, on the weights' device.

    The draw runs on the CPU (``generator`` is a CPU generator), so a seed
    gives the same hypotheses whichever device the geometry runs on; the
    indices then move to the device."""
    cpu_weights = weights.detach().to("cpu", torch.float64)
    idx = torch.multinomial(
        cpu_weights.expand(num_hypotheses, -1), sample_size, replacement=False,
        generator=generator,
    )
    return idx.to(weights.device)


def two_view_reconstruction(
    p1,
    p2,
    mask,
    samples=None,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 128,
    inlier_threshold: float = 2e-5,
    planar_ratio: float = 0.40,
) -> TwoViewResult:
    """Batched-RANSAC two-view initialization with H/F model selection.

    p1, p2: [N, 2] normalized correspondences; mask: [N] valid-match flags;
    samples: optional [num_hypotheses, 8] int indices (else drawn from the
    CPU ``generator``, weighted by mask + 1e-6 as the reference). When the
    homography's truncated-chi2 score share
    SH / (SH + SF) exceeds ``planar_ratio``, the pose comes from the
    homography decomposition, otherwise from the essential matrix
    (Initializer.cc:104-124)."""
    if samples is None:
        samples = draw_samples(mask.to(torch.float32) + 1e-6, num_hypotheses, 8, generator)
    samples = samples.to(device=p1.device, dtype=torch.int64)

    es = _essential_from_eight(p1[samples], p2[samples])  # [H, 3, 3]
    errs = _sampson_error(es, p1, p2)  # [H, N]
    scores = ((errs < inlier_threshold) & mask).sum(-1)
    best = torch.argmax(scores)
    e = es[best]
    err = errs[best]
    inliers = (err < inlier_threshold) & mask

    # Refit on all inliers (least squares over the inlier set).
    a = (_homogeneous(p2)[:, :, None] * _homogeneous(p1)[:, None, :]).reshape(-1, 9)
    a = a * inliers[:, None].to(a.dtype)
    _, _, vt = torch.linalg.svd(a, full_matrices=False)
    e_ref = _project_essential(vt[-1].reshape(3, 3))
    err_ref = _sampson_error(e_ref, p1, p2)
    inliers_ref = (err_ref < inlier_threshold) & mask
    use_refit = inliers_ref.sum() >= inliers.sum()
    e_final = torch.where(use_refit, e_ref, e)
    inliers = torch.where(use_refit, inliers_ref, inliers)
    err_e = torch.where(use_refit, err_ref, err)

    # Homography model on the first 4 of each 8-sample.
    h_gate = 2.0 * inlier_threshold
    hs = _homography_from_four(p1[samples[:, :4]], p2[samples[:, :4]])
    errs_h = _homography_sym_error(hs, p1, p2)
    best_h = torch.argmax(((errs_h < h_gate) & mask).sum(-1))
    h_best = hs[best_h]
    err_h = errs_h[best_h]
    inliers_h = (err_h < h_gate) & mask

    maskf = mask.to(p1.dtype)
    sh = ((h_gate - err_h).clamp_min(0.0) * maskf).sum()
    sf = ((inlier_threshold - err_e).clamp_min(0.0) * maskf).sum() * 2.0
    rh = sh / torch.clamp_min(sh + sf, 1e-18)

    r_e, t_e, pts_e, good_e, _ = recover_pose(e_final, p1, p2, inliers)
    r_h, t_h, pts_h, good_h, _ = recover_pose_homography(h_best, p1, p2, inliers_h)

    use_h = rh > planar_ratio
    r21 = torch.where(use_h, r_h, r_e)
    t21 = torch.where(use_h, t_h, t_e)
    pts = torch.where(use_h, pts_h, pts_e)
    good = torch.where(use_h, good_h & inliers_h, good_e & inliers)
    return TwoViewResult(r21, t21, pts, good, good.sum())
