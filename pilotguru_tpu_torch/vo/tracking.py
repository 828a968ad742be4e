"""Monocular visual-odometry tracker: host state machine + device compute
(port of pilotguru_tpu/vo/tracking.py, the per-frame path).

Per frame: projected matching against the local map plus robust pose
refinement (``fused_track_step``), with reference-keyframe re-tracking and
relocalization as fallbacks; at keyframes: map-point culling, triangulation
against the recent keyframes, duplicate fusion, local bundle adjustment
(deferred to the next keyframe, as the reference's LocalMapping thread) and
keyframe culling. The numerics run on the tracker's device; the map
bookkeeping stays on the host in numpy, exactly as in the reference.

Per-frame poses are stored relative to their reference keyframe and the
absolute trajectory is rebuilt from the current keyframe poses
(``final_trajectory``), so BA corrections reach every frame.

Not ported yet (see ROADMAP.md): chunked tracking (``track_chunk_frames``)
and loop closing (``enable_loop_closing``); the config refuses both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from pilotguru_tpu_torch.vo import matching
from pilotguru_tpu_torch.vo.ba import BAProblem, bundle_adjust
from pilotguru_tpu_torch.vo.features import extract_orb_features
from pilotguru_tpu_torch.vo.pose import (
    optimize_pose,
    project,
    rotvec_to_matrix,
    skew,
    transform,
)
from pilotguru_tpu_torch.vo.relocalize import relocalize
from pilotguru_tpu_torch.vo.twoview import triangulate, two_view_reconstruction

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


# Host-side 3x3 rotation helpers: pose composition runs several times per
# frame on 3-vectors, where host numpy costs microseconds.
def np_rotvec_to_matrix(w):
    theta2 = float(w @ w)
    theta = np.sqrt(theta2 + 1e-30)
    k = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )
    if theta2 < 1e-12:
        a = 1.0 - theta2 / 6.0
        b = 0.5 - theta2 / 24.0
    else:
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    return np.eye(3) + a * k + b * (k @ k)


def np_matrix_to_rotvec(r):
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    axis_raw = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    )
    sin = np.linalg.norm(axis_raw) / 2.0
    scale = theta / (2.0 * sin) if sin > 1e-9 else 0.5
    return axis_raw * scale


def np_matrix_to_quat(r):
    qw = np.sqrt(max(1.0 + r[0, 0] + r[1, 1] + r[2, 2], 1e-12)) / 2.0
    qx = np.sqrt(max(1.0 + r[0, 0] - r[1, 1] - r[2, 2], 1e-12)) / 2.0
    qy = np.sqrt(max(1.0 - r[0, 0] + r[1, 1] - r[2, 2], 1e-12)) / 2.0
    qz = np.sqrt(max(1.0 - r[0, 0] - r[1, 1] + r[2, 2], 1e-12)) / 2.0
    qx *= np.sign(r[2, 1] - r[1, 2]) or 1.0
    qy *= np.sign(r[0, 2] - r[2, 0]) or 1.0
    qz *= np.sign(r[1, 0] - r[0, 1]) or 1.0
    q = np.array([qw, qx, qy, qz])
    return q / np.linalg.norm(q)


def _packed(*parts):
    """One float32 result vector per device program, pulled to the host in
    one copy (small integer indices are exact in float32). The pose rides
    in float32 too, as in the reference's packed pulls."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


def fused_track_step(
    points,  # [M, 3] map points
    point_desc,  # [M, 256] uint8
    cand_mask,  # [M] bool — valid & local
    point_level,  # [M] int32 — creating keypoint's pyramid level
    predicted,  # [6] pose guess
    kp_norm,  # [K, 2]
    kp_desc,  # [K, 256]
    kp_valid,  # [K] bool
    kp_level,  # [K] int32
    search_radius: float,
    max_distance: int,
    scale: float = 1.2,
    level_window: int = 2,
    refine_radius: float = 0.0,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
):
    """One tracking attempt: frustum test, octave-aware projected matching
    and robust pose refinement — run twice, a wide motion-model window
    (TrackWithMotionModel) then a tight window around the refined pose
    (TrackLocalMap); ``refine_radius`` <= 0 skips the second pass.

    Returns the packed float32 vector
    [pose6, num_inliers, match_idx[M], inliers[M], in_view[M]]."""
    big = torch.full((), float("inf"), dtype=kp_norm.dtype, device=kp_norm.device)
    lo = torch.where(kp_valid[:, None], kp_norm, big).min(dim=0).values
    hi = torch.where(kp_valid[:, None], kp_norm, -big).max(dim=0).values
    any_kp = kp_valid.any()
    dtype = points.dtype
    far = torch.full((), 1e3, dtype=dtype, device=points.device)
    zero = torch.zeros((), dtype=dtype, device=points.device)
    one = torch.ones((), dtype=dtype, device=points.device)

    def attempt(pose6, radius):
        cam = transform(pose6, points)
        in_front = (cam[:, 2] > 0.05) & cand_mask
        proj = torch.where(in_front[:, None], project(cam), far)
        in_view = in_front & ((proj >= lo - radius) & (proj <= hi + radius)).all(dim=1)
        in_view = torch.where(any_kp, in_view, in_front)
        m = matching.match_projected(
            point_desc, proj, kp_desc, kp_norm,
            search_radius=radius, valid_a=in_front, valid_b=kp_valid,
            max_distance=max_distance, level_a=point_level, level_b=kp_level,
            scale=scale, level_window=level_window,
        )
        idx = m.index.clamp_min(0).long()
        obs = torch.where(m.valid[:, None], kp_norm[idx], zero)
        # Information weights from the matched keypoint's level
        # (invSigma2 of the observing octave, Optimizer.cc:126-127).
        inv_s = torch.where(m.valid, (1.0 / scale) ** kp_level[idx].to(dtype), one)
        res = optimize_pose(
            pose6, points, obs, m.valid, obs_invsigma=inv_s,
            huber_delta=huber_delta, inlier_threshold=inlier_threshold,
        )
        return res, m, in_view

    res, m, in_view = attempt(predicted, search_radius)
    if refine_radius > 0.0:
        res2, m2, in_view2 = attempt(res.pose6, refine_radius)
        # Keep the refined result unless the tight window collapsed the
        # match set.
        better = res2.num_inliers >= torch.clamp_max(res.num_inliers, 10)
        res = type(res)(*(torch.where(better, a, b) for a, b in zip(res2, res)))
        m = matching.Matches(*(torch.where(better, a, b) for a, b in zip(m2, m)))
        in_view = torch.where(better, in_view2, in_view)
    return _packed(res.pose6, res.num_inliers, m.index, res.inliers, in_view)


def fused_ref_kf_track(
    kf_points,  # [K, 3] map-point positions per reference-keyframe keypoint
    kf_has_point,  # [K] bool
    kf_desc,  # [K, 256]
    kf_angle,  # [K]
    kf_point_ids,  # [K] int — map-point slot per keypoint (or 0)
    pose0,  # [6] last tracked pose
    kp_norm,  # [Kc, 2] current frame
    kp_desc,  # [Kc, 256]
    kp_valid,  # [Kc] bool
    kp_level,  # [Kc] int32
    kp_angle,  # [Kc]
    scale: float = 1.2,
    use_rotation_check: bool = True,
    huber_delta: float = 0.006,
    inlier_threshold: float = 0.01,
):
    """TrackReferenceKeyFrame (Tracking.cc:317-323): descriptor-only matching
    against the reference keyframe's map-point observations, then robust
    pose refinement from the last pose. Packed result:
    [pose6, num_inliers, point_id[Kc], inlier[Kc]]."""
    m = matching.match_descriptors(
        kp_desc, kf_desc, valid_a=kp_valid, valid_b=kf_has_point,
        max_distance=matching.HAMMING_LOW, ratio=0.7,
    )
    if use_rotation_check:
        m = matching.rotation_consistency(kp_angle, kf_angle, m)
    idx = m.index.clamp_min(0).long()
    dtype = kf_points.dtype
    inv_s = torch.where(
        m.valid, (1.0 / scale) ** kp_level.to(dtype),
        torch.ones((), dtype=dtype, device=kf_points.device),
    )
    res = optimize_pose(
        pose0, kf_points[idx], kp_norm, m.valid, obs_invsigma=inv_s,
        huber_delta=huber_delta, inlier_threshold=inlier_threshold,
    )
    point_ids = torch.where(m.valid, kf_point_ids[idx], torch.full_like(kf_point_ids[idx], -1))
    return _packed(res.pose6, res.num_inliers, point_ids, res.inliers)


def create_points(
    prev_desc,  # [K, 256]
    prev_un,  # [K] bool — unmatched & valid in previous keyframe
    prev_kp,  # [K, 2]
    prev_level,  # [K] int32
    prev_angle,  # [K]
    curr_desc,  # [K, 256]
    curr_un,  # [K] bool
    curr_kp,  # [K, 2]
    curr_level,  # [K] int32
    curr_angle,  # [K]
    delta6,  # [6] prev->curr relative pose
    prev_pose6,  # [6] world->prev camera
    min_parallax_cos: float,
    scale: float = 1.2,
    use_rotation_check: bool = True,
    reproj_gate: float = 0.01,
    epipolar_gate: float = 0.0,
):
    """LocalMapping::CreateNewMapPoints for one keyframe pair: descriptor
    matching, epipolar gating (``epipolar_gate`` > 0), rotation consistency,
    triangulation and cheirality / parallax / reprojection / scale gates,
    then the world-frame transform. Packed result:
    [match_idx[K], good[K], pts_world[K, 3]]."""
    m = matching.match_descriptors(
        prev_desc, curr_desc, valid_a=prev_un, valid_b=curr_un,
        max_distance=matching.HAMMING_LOW, ratio=0.85,
    )
    if use_rotation_check:
        m = matching.rotation_consistency(prev_angle, curr_angle, m)
    dtype = prev_kp.dtype
    idx = m.index.clamp_min(0).long()
    p1 = prev_kp
    p2 = curr_kp[idx]
    r21 = rotvec_to_matrix(delta6[:3])
    t21 = delta6[3:]
    if epipolar_gate > 0.0:
        essential = skew(t21) @ r21
        ones = torch.ones_like(p1[:, :1])
        x1 = torch.cat([p1, ones], dim=-1)
        x2 = torch.cat([p2, ones], dim=-1)
        ex1 = x1 @ essential.T
        etx2 = x2 @ essential
        sampson_sq = (x2 * ex1).sum(-1) ** 2 / (
            ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2 + 1e-18
        )
        sigma2_gate = scale ** curr_level[idx].to(dtype)
        epi_ok = sampson_sq < (epipolar_gate * sigma2_gate) ** 2
        m = matching.Matches(
            index=torch.where(epi_ok, m.index, torch.full_like(m.index, -1)),
            distance=m.distance,
            valid=m.valid & epi_ok,
        )
        idx = m.index.clamp_min(0).long()
        p2 = curr_kp[idx]
    pts_prev = triangulate(r21, t21, p1, p2)

    z1 = pts_prev[:, 2]
    cam2 = pts_prev @ r21.T + t21
    z2 = cam2[:, 2]
    ray1 = pts_prev / (torch.linalg.vector_norm(pts_prev, dim=1, keepdim=True) + 1e-12)
    c2_in_prev = -(r21.T @ t21)
    ray2 = pts_prev - c2_in_prev
    ray2 = ray2 / (torch.linalg.vector_norm(ray2, dim=1, keepdim=True) + 1e-12)
    parallax_cos = (ray1 * ray2).sum(1)
    reproj1 = torch.linalg.vector_norm(pts_prev[:, :2] / z1[:, None] - p1, dim=1)
    reproj2 = torch.linalg.vector_norm(
        cam2[:, :2] / z2.clamp_min(1e-9)[:, None] - p2, dim=1
    )
    sigma1 = scale ** prev_level.to(dtype)
    sigma2 = scale ** curr_level[idx].to(dtype)
    # Scale consistency (LocalMapping.cc:427-432): distance ratio to the two
    # camera centres within ratioFactor = 1.5 * scale of the octave ratio.
    dist1 = torch.linalg.vector_norm(pts_prev, dim=1)
    dist2 = torch.linalg.vector_norm(pts_prev - c2_in_prev, dim=1)
    ratio_dist = dist2 / dist1.clamp_min(1e-12)
    ratio_octave = sigma1 / sigma2
    ratio_factor = 1.5 * scale
    scale_ok = (ratio_dist * ratio_factor >= ratio_octave) & (
        ratio_dist <= ratio_octave * ratio_factor
    )
    good = (
        m.valid
        & (z1 > 0.05) & (z2 > 0.05)
        & (parallax_cos < min_parallax_cos)
        & (reproj1 < reproj_gate * sigma1) & (reproj2 < reproj_gate * sigma2)
        & scale_ok
        & torch.isfinite(pts_prev).all(dim=1)
    )
    r_prev = rotvec_to_matrix(prev_pose6[:3])
    pts_world = (pts_prev - prev_pose6[3:]) @ r_prev  # R^T (x - t)
    return _packed(m.index, good, pts_world)


def fused_project_match(
    points, point_desc, cand_mask, point_level, pose6,
    kp_desc, kp_norm, kp_valid, kp_level,
    search_radius: float, max_distance: int,
    scale: float = 1.2, level_window: int = 2,
):
    """Project candidate map points into a keyframe and match (the fusion
    search). Packed result: [match_idx[M], ok[M]]."""
    cam = transform(pose6, points)
    in_front = (cam[:, 2] > 0.05) & cand_mask
    far = torch.full((), 1e3, dtype=points.dtype, device=points.device)
    proj = torch.where(in_front[:, None], project(cam), far)
    m = matching.match_projected(
        point_desc, proj, kp_desc, kp_norm,
        search_radius=search_radius, valid_a=in_front, valid_b=kp_valid,
        max_distance=max_distance, level_a=point_level, level_b=kp_level,
        scale=scale, level_window=level_window,
    )
    return _packed(m.index, m.valid)


@dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    # Radial/tangential lens distortion (OpenCV convention); keypoints are
    # undistorted before any geometry (Frame.cc UndistortKeyPoints).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def has_distortion(self) -> bool:
        return any(abs(c) > 1e-12 for c in (self.k1, self.k2, self.p1, self.p2))

    def _undistort_steps(self, xd, yd):
        """Fixed-point inversion of the distortion model (the
        cv2.undistortPoints scheme, 40 rounds); numpy or torch arrays."""
        x, y = xd, yd
        for _ in range(40):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + self.k2 * r2)
            dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return x, y

    def normalize(self, xy):
        """Pixel -> undistorted normalized-plane coordinates (host numpy)."""
        x = (xy[..., 0] - self.cx) / self.fx
        y = (xy[..., 1] - self.cy) / self.fy
        if self.has_distortion():
            x, y = self._undistort_steps(x, y)
        return np.stack([x, y], axis=-1)

    def denormalize(self, xy_norm):
        """Undistorted normalized-plane -> pixel coordinates (host numpy)."""
        x = xy_norm[..., 0]
        y = xy_norm[..., 1]
        if self.has_distortion():
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + self.k2 * r2)
            xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
            yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
            x, y = xd, yd
        return np.stack([x * self.fx + self.cx, y * self.fy + self.cy], axis=-1)


def normalize_keypoints_device(xy: torch.Tensor, camera: CameraModel):
    """Device twin of CameraModel.normalize: [K, 2] pixels -> normalized."""
    x = (xy[..., 0] - camera.cx) / camera.fx
    y = (xy[..., 1] - camera.cy) / camera.fy
    if camera.has_distortion():
        x, y = camera._undistort_steps(x, y)
    return torch.stack([x, y], dim=-1)


def extract_frame_features(gray, camera: CameraModel, config: "TrackerConfig",
                           device) -> tuple:
    """ORB features of one frame, extracted on ``device``: host arrays
    (kp_norm [K, 2] float32, desc [K, 256] uint8, valid [K] bool,
    level [K] int32, angle [K] float32).

    Keypoints are normalized on the device and every per-keypoint quantity
    rides back in one packed float32 array plus the descriptors (two
    device-to-host copies per frame)."""
    if isinstance(gray, np.ndarray):
        gray = torch.from_numpy(np.ascontiguousarray(gray))
    gray = gray.to(device)
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) / 255.0
    kps = extract_orb_features(
        gray.to(torch.float32),
        num_levels=config.num_levels,
        scale=config.scale,
        total_budget=config.total_budget,
        threshold=config.fast_threshold,
    )
    kp_norm = normalize_keypoints_device(kps.xy, camera)
    packed = torch.cat(
        [kp_norm, kps.valid.to(torch.float32)[:, None],
         kps.level.to(torch.float32)[:, None], kps.angle[:, None]],
        dim=1,
    ).cpu().numpy()
    desc = kps.descriptors.cpu().numpy()
    return (
        packed[:, :2],
        desc,
        packed[:, 2] > 0.5,
        packed[:, 3].astype(np.int32),
        packed[:, 4].copy(),
    )


@dataclass(frozen=True)
class TrackerConfig:
    # Reference feature budget: 2000 features over 8 pyramid levels
    # (calibrate.cc:518-531).
    total_budget: int = 2000
    num_levels: int = 8
    scale: float = 1.2  # pyramid scale factor (ORBextractor_scaleFactor)
    fast_threshold: float = 20.0 / 255.0
    max_map_points: int = 4096
    # Octave-aware matching: search radii scale with the map point's
    # creation level, candidates sit within this many octaves, residuals are
    # information-weighted by the observing keypoint's level.
    level_window: int = 2
    rotation_consistency: bool = True  # ORBmatcher CheckOrientation
    # Pixel-calibrated geometric gates, converted to normalized units with
    # the camera's fx at tracker construction (explicit *_radius overrides
    # win; unit-test scenes feed normalized coordinates directly).
    track_search_px: float = 15.0  # motion-model window (ORBmatcher th=15 mono)
    track_refine_px: float = 4.0  # post-refinement local-map window
    fuse_search_px: float = 5.0  # duplicate-fusion projection window
    reproj_gate_px: float = 2.5  # triangulation reprojection gate (~sqrt(5.991))
    epipolar_gate_px: float = 2.0  # triangulation epipolar gate (~sqrt(3.84))
    inlier_px: float = 2.5  # pose/BA chi2 inlier gate
    huber_px: float = 1.5  # robust-loss knee
    # Monocular initialization matches only the finest pyramid levels, and
    # retries with all levels when the initial map would start thinner
    # than init_rich_points.
    init_max_level: int = 0
    init_rich_points: int = 100
    # TrackReferenceKeyFrame fallback before relocalization.
    track_ref_kf_fallback: bool = True
    # Chunked tracking (several frames per device program) is not ported:
    # 0 is the only accepted value (ROADMAP.md, Queue 1 "chunked tracking").
    track_chunk_frames: int = 0
    chunk_through_keyframes: bool = True
    # Triangulate each new keyframe against its N most recent predecessors.
    create_neighbor_kfs: int = 3
    local_window: int = 6  # keyframes in local BA
    min_init_matches: int = 60
    min_init_inliers: int = 40
    min_track_inliers: int = 25
    keyframe_inlier_ratio: float = 0.75
    keyframe_max_gap: int = 8
    # Normalized-plane override for the motion-model search window.
    match_search_radius: Optional[float] = None
    min_parallax_cos: float = 0.9999
    ba_every_keyframe: bool = True
    # Local BA applies at the NEXT keyframe insertion (the reference's
    # LocalMapping-thread lag); False applies it at once.
    ba_async: bool = True
    # --- map maintenance (LocalMapping parity) ---
    cull_found_ratio: float = 0.25  # MapPointCulling GetFoundRatio threshold
    cull_min_observations: int = 2  # monocular cnThObs (LocalMapping.cc:177)
    fuse_search_radius: Optional[float] = None  # normalized override
    keyframe_cull_redundancy: float = 0.9  # KeyFrameCulling 90% rule
    keyframe_cull_min_obs: int = 3  # "seen in at least other 3 keyframes"
    # --- loop closing: not ported; False is the only accepted value
    # (ROADMAP.md, Queue 1 "loop closing"). The thresholds below are kept
    # so configurations interchange with the reference.
    enable_loop_closing: bool = False
    loop_exclude_recent: int = 10
    loop_min_match_count: int = 50
    loop_min_inliers: int = 20
    loop_cooldown_keyframes: int = 10
    loop_ba: str = "global"

    def __post_init__(self):
        if self.track_chunk_frames != 0:
            raise NotImplementedError(
                "track_chunk_frames > 0 (chunked tracking) is not ported to "
                "pilotguru_tpu_torch yet; see ROADMAP.md Queue 1, chunked tracking"
            )
        if self.enable_loop_closing:
            raise NotImplementedError(
                "enable_loop_closing=True is not ported to pilotguru_tpu_torch "
                "yet; see ROADMAP.md Queue 1, loop closing"
            )


@dataclass
class FramePose:
    frame_id: int
    time_usec: int
    pose6: np.ndarray  # world->camera [rotvec, t] at track time
    is_lost: bool = False
    # Reference-keyframe anchoring (System::GetTrajectory semantics).
    ref_kf_id: int = -1
    rel6: Optional[np.ndarray] = None

    def camera_to_world_quat(self) -> np.ndarray:
        return np_matrix_to_quat(np_rotvec_to_matrix(self.pose6[:3]).T)

    def camera_center(self) -> np.ndarray:
        r = np_rotvec_to_matrix(self.pose6[:3])
        return -(r.T @ self.pose6[3:])


class _FrameFeatures(NamedTuple):
    """One frame's extracted features as fed to the tracker (host arrays)."""

    kp_norm: np.ndarray  # [K, 2]
    desc: np.ndarray  # [K, 256] uint8
    valid: np.ndarray  # [K] bool
    level: np.ndarray  # [K] int32
    angle: np.ndarray  # [K] float32


class Keyframe:
    """One keyframe's host-side state (identity semantics: bookkeeping
    compares keyframes by object; ``kf_id`` survives keyframe culling)."""

    def __init__(
        self, pose6, kp_norm, descriptors, kp_valid, map_point,
        num_inliers, kf_id, kp_level, kp_angle,
    ):
        self.pose6 = pose6
        self.kp_norm = kp_norm  # [K, 2] normalized coords
        self.descriptors = descriptors  # [K, 256] uint8
        self.kp_valid = kp_valid  # [K] bool
        self.map_point = map_point  # [K] int32 — map point index or -1
        self.num_inliers = num_inliers
        self.kf_id = kf_id
        self.kp_level = kp_level  # [K] int32 pyramid level
        self.kp_angle = kp_angle  # [K] float32 orientation


class MonocularTracker:
    """Feature-based monocular odometry over a frame stream.

    ``device``: where the numerics run; ``dtype``: the geometry dtype
    (default float64 on a CPU device, float32 on CUDA, as ``--dtype auto``)."""

    def __init__(
        self,
        camera: CameraModel,
        config: TrackerConfig = TrackerConfig(),
        device="cpu",
        dtype: Optional[torch.dtype] = None,
    ):
        self.camera = camera
        self.config = config
        self.device = torch.device(device)
        self.dtype = dtype or (
            torch.float64 if self.device.type == "cpu" else torch.float32
        )
        self.state = NOT_INITIALIZED
        # Pixel gates -> normalized-plane units via the focal (unit-test rigs
        # with an fx=1 identity camera convert at 250 px).
        fx = float(camera.fx)
        if fx <= 10.0:
            fx = 250.0
        self._search_rad = (
            config.match_search_radius
            if config.match_search_radius is not None
            else config.track_search_px / fx
        )
        self._refine_rad = (
            min(self._search_rad, config.track_refine_px / fx)
            if config.match_search_radius is None
            else self._search_rad
        )
        self._fuse_rad = (
            config.fuse_search_radius
            if config.fuse_search_radius is not None
            else config.fuse_search_px / fx
        )
        self._reproj_gate = config.reproj_gate_px / fx
        self._epi_gate = config.epipolar_gate_px / fx
        self._inlier_thresh = config.inlier_px / fx
        self._huber = config.huber_px / fx
        # Map storage (fixed capacity), host side.
        m = config.max_map_points
        self.points = np.zeros((m, 3), np.float64)
        self.point_desc = np.zeros((m, 256), np.uint8)
        self.point_valid = np.zeros((m,), bool)
        self.point_level = np.zeros((m,), np.int32)
        self.point_angle = np.zeros((m,), np.float32)
        self.point_visible = np.zeros((m,), np.int32)  # frustum appearances
        self.point_found = np.zeros((m,), np.int32)  # tracked-inlier hits
        self.point_first_kf = np.full((m,), -1, np.int32)  # creating kf_id
        self.point_recent = np.zeros((m,), bool)  # in the recent-cull list
        self.keyframes: List[Keyframe] = []
        self.trajectory: List[FramePose] = []
        self._init_frame = None
        self._init_attempts = 0
        self._pose = np.zeros(6)
        self._motion = np.zeros(6)
        # Keypoint rows tracked as inliers in the latest frame (overlay).
        self.last_track_kp_rows = np.zeros(0, np.int32)
        self._frames_since_keyframe = 0
        # RANSAC draws come from a seeded CPU generator: the same hypotheses
        # on every device (vo/twoview.draw_samples).
        self._generator = torch.Generator()
        self._generator.manual_seed(0)
        self._next_kf_id = 0
        # Deferred local BA: (result, window keyframes, arena pids).
        self._pending_ba = None
        # Local map: points observed by the recent keyframe window; per-frame
        # tracking matches only these (TrackLocalMap semantics).
        self._local_points = np.zeros((m,), bool)
        # Device copies of keyframe descriptors, keyed by kf_id.
        self._kf_desc_dev: Dict[int, tuple] = {}
        # Device map mirrors, rebuilt after map mutations (keyframe cadence).
        self._dev_map = None
        self._dev_map_sel = None  # arena indices behind the compact mirror
        self._dev_map_count = 0
        self._dev_map_full = None  # full-arena mirror (relocalization only)
        self.stats: Dict[str, int] = {
            "points_created": 0,
            "points_culled": 0,
            "points_fused": 0,
            "points_recycled": 0,
            "points_skipped_capacity": 0,
            "keyframes_culled": 0,
            "loop_closures": 0,
            "ref_kf_recoveries": 0,
        }

    # ------------------------------------------------------------- device io
    def _t(self, array, dtype=None):
        """Host array -> tensor on the tracker's device (geometry dtype for
        floating arrays unless ``dtype`` is given)."""
        t = torch.as_tensor(np.asarray(array))
        if dtype is None and t.is_floating_point():
            dtype = self.dtype
        return t.to(device=self.device, dtype=dtype)

    def _invalidate_device_map(self):
        self._dev_map = None
        self._dev_map_sel = None
        self._dev_map_full = None

    def _device_map(self):
        """Compact local-map mirror on the device: the candidate points
        (valid & local) gathered into a power-of-two bucket (floor 1024), so
        the [M, K] tables of the per-frame path scale with the local map.
        Returns (points [B, 3], desc [B, 256], mask [B], level [B])."""
        if self._dev_map is None:
            cap = self.config.max_map_points
            cand = np.nonzero(self.point_valid & self._local_points)[0]
            bucket = min(1024, cap)
            while bucket < len(cand):
                bucket *= 2
            bucket = min(bucket, cap)
            sel = np.zeros(bucket, np.int64)
            sel[: len(cand)] = cand
            mask = np.zeros(bucket, bool)
            mask[: len(cand)] = True
            self._dev_map_sel = sel
            self._dev_map_count = len(cand)
            self._dev_map = (
                self._t(self.points[sel]),
                self._t(self.point_desc[sel]),
                self._t(mask),
                self._t(self.point_level[sel]),
            )
        return self._dev_map

    def _device_map_full(self):
        """Full-arena mirror: relocalization searches the whole map."""
        if self._dev_map_full is None:
            self._dev_map_full = (
                self._t(self.points),
                self._t(self.point_desc),
                self._t(self.point_valid),
            )
        return self._dev_map_full

    def kf_descriptors_device(self, kf: Keyframe):
        """Device copies of a keyframe's (descriptors, validity), cached."""
        if kf.kf_id not in self._kf_desc_dev:
            self._kf_desc_dev[kf.kf_id] = (self._t(kf.descriptors), self._t(kf.kp_valid))
        return self._kf_desc_dev[kf.kf_id]

    # ---------------------------------------------------------------- utils
    def _point_observations(self) -> np.ndarray:
        """Number of keyframes observing each map point ([max_map_points])."""
        obs = np.zeros(self.config.max_map_points, np.int64)
        for kf in self.keyframes:
            refs = kf.map_point[kf.map_point >= 0]
            np.add.at(obs, refs, 1)
        return obs

    def _cull_points(self, pids: np.ndarray):
        """Remove map points: free slots + drop keyframe references."""
        if pids.size == 0:
            return
        self.point_valid[pids] = False
        self.point_recent[pids] = False
        self.point_visible[pids] = 0
        self.point_found[pids] = 0
        self.point_first_kf[pids] = -1
        dead = np.zeros(self.config.max_map_points, bool)
        dead[pids] = True
        for kf in self.keyframes:
            refs = kf.map_point >= 0
            kill = np.zeros_like(refs)
            kill[refs] = dead[kf.map_point[refs]]
            kf.map_point[kill] = -1
        self.stats["points_culled"] += int(pids.size)

    def _free_slots(self, count):
        """Indices of ``count`` free map slots, recycling the lowest
        found-ratio points outside the local window under arena pressure;
        a shortfall beyond that is reported in points_skipped_capacity."""
        free = np.nonzero(~self.point_valid)[0]
        if free.size >= count:
            return free[:count]
        needed = count - free.size
        in_window = np.zeros(self.config.max_map_points, bool)
        for kf in self.keyframes[-self.config.local_window:]:
            in_window[kf.map_point[kf.map_point >= 0]] = True
        candidates = np.nonzero(self.point_valid & ~in_window)[0]
        if candidates.size:
            ratio = self.point_found[candidates] / np.maximum(
                self.point_visible[candidates], 1
            )
            victims = candidates[np.argsort(ratio, kind="stable")[:needed]]
            self._cull_points(victims)
            self.stats["points_recycled"] += int(victims.size)
            self.stats["points_culled"] -= int(victims.size)  # counted above
            free = np.nonzero(~self.point_valid)[0]
        if free.size < count:
            self.stats["points_skipped_capacity"] += int(count - free.size)
        return free[:count]

    def _refresh_local_points(self):
        """Local map = points observed by the recent keyframe window; the
        single choke point that invalidates the device mirrors."""
        local = np.zeros(self.config.max_map_points, bool)
        for kf in self.keyframes[-self.config.local_window:]:
            local[kf.map_point[kf.map_point >= 0]] = True
        self._local_points = local & self.point_valid
        self._invalidate_device_map()

    # ------------------------------------------------------------ lifecycle
    def features(self, gray):
        """One frame's features (extract_frame_features' host arrays)."""
        return extract_frame_features(gray, self.camera, self.config, self.device)

    def process_features(
        self, kp_norm, desc, valid, frame_id: int, time_usec: int,
        kp_level, kp_angle,
    ) -> str:
        """Feed one frame's extracted features (host arrays)."""
        frame = _FrameFeatures(kp_norm, np.asarray(desc), valid, kp_level, kp_angle)
        if self.state == NOT_INITIALIZED:
            self._try_initialize(frame, frame_id, time_usec)
        elif self.state == OK:
            self._track(frame, frame_id, time_usec)
        return self.state

    def _append_frame(self, frame_id, time_usec, pose6, is_lost=False):
        kf = self.keyframes[-1] if self.keyframes else None
        rel = self._pose_delta(kf.pose6, pose6) if kf is not None else None
        self.trajectory.append(
            FramePose(
                frame_id, time_usec, np.asarray(pose6).copy(), is_lost=is_lost,
                ref_kf_id=kf.kf_id if kf is not None else -1, rel6=rel,
            )
        )

    def final_trajectory(self) -> List[FramePose]:
        """Absolute per-frame poses rebuilt from the CURRENT keyframe poses
        (System::GetTrajectory semantics, System.cc:371-413)."""
        self._apply_pending_ba()
        by_id = {kf.kf_id: kf for kf in self.keyframes}
        out = []
        for fp in self.trajectory:
            kf = by_id.get(fp.ref_kf_id)
            if kf is None or fp.rel6 is None:
                pose = fp.pose6
            else:
                pose = self._compose(fp.rel6, kf.pose6)
            out.append(
                FramePose(fp.frame_id, fp.time_usec, np.asarray(pose),
                          is_lost=fp.is_lost, ref_kf_id=fp.ref_kf_id,
                          rel6=fp.rel6)
            )
        return out

    def finalize(self):
        """End of segment: fold in the last deferred local BA."""
        self._apply_pending_ba()

    # ------------------------------------------------------- initialization
    def _try_initialize(self, frame: _FrameFeatures, frame_id, time_usec):
        kp_norm, desc, valid = frame.kp_norm, frame.desc, frame.valid
        if self._init_frame is None:
            self._init_frame = (frame, frame_id, time_usec)
            return
        prev, fid0, t0 = self._init_frame
        kp0, d0, v0 = prev.kp_norm, prev.desc, prev.valid

        # Octave-0 keypoints only (SearchForInitialization); all levels when
        # the level-0 map would start too thin (init_rich_points).
        def match_levels(max_level):
            m = matching.match_descriptors(
                self._t(d0), self._t(desc),
                valid_a=self._t(v0 & (prev.level <= max_level)),
                valid_b=self._t(valid & (frame.level <= max_level)),
                max_distance=matching.HAMMING_LOW, ratio=0.9,
            )
            if self.config.rotation_consistency:
                m = matching.rotation_consistency(
                    self._t(prev.angle, torch.float32), self._t(frame.angle, torch.float32), m
                )
            return m.index.cpu().numpy(), m.valid.cpu().numpy()

        def solve_two_view(idx, ok):
            p1 = np.where(ok[:, None], kp0, 0.0)
            p2 = np.where(ok[:, None], kp_norm[np.clip(idx, 0, None)], 0.0)
            res = two_view_reconstruction(
                self._t(p1), self._t(p2), self._t(ok), generator=self._generator,
            )
            return res, res.inliers.cpu().numpy()

        idx, ok = match_levels(self.config.init_max_level)
        res, inl = (None, np.zeros(0, bool))
        if ok.sum() >= self.config.min_init_matches:
            res, inl = solve_two_view(idx, ok)
        if (
            int(inl.sum()) < self.config.init_rich_points
            and self.config.init_max_level < self.config.num_levels - 1
        ):
            idx2, ok2 = match_levels(self.config.num_levels - 1)
            if ok2.sum() >= self.config.min_init_matches:
                res2, inl2 = solve_two_view(idx2, ok2)
                if int(inl2.sum()) > int(inl.sum()):
                    idx, ok, res, inl = idx2, ok2, res2, inl2
        if ok.sum() < self.config.min_init_matches:
            self._init_attempts += 1
            if self._init_attempts > 5:
                # Reset the initial frame when matching keeps failing
                # (Tracking::MonocularInitialization).
                self._init_frame = (frame, frame_id, time_usec)
                self._init_attempts = 0
            return
        if int(inl.sum()) < self.config.min_init_inliers:
            self._init_attempts += 1
            return
        pts = res.points3d.cpu().numpy().astype(np.float64)
        # Monocular scale: median depth of inliers -> 1.
        scale = 1.0 / max(np.median(pts[inl, 2]), 1e-6)
        pts = pts * scale
        t21 = res.translation.cpu().numpy().astype(np.float64) * scale
        r21 = res.rotation.cpu().numpy().astype(np.float64)

        n_new = int(inl.sum())
        slots = self._free_slots(n_new)
        src_rows = np.nonzero(inl)[0][: len(slots)]
        dst_rows = np.clip(idx[src_rows], 0, None)
        self.points[slots] = pts[src_rows]
        self.point_desc[slots] = desc[dst_rows]
        self.point_valid[slots] = True
        self.stats["points_created"] += len(slots)
        self.point_level[slots] = frame.level[dst_rows]
        self.point_angle[slots] = frame.angle[dst_rows]
        self.point_visible[slots] = 2
        self.point_found[slots] = 2
        # Created "at" the second init keyframe (mnFirstKFid = 1).
        self.point_first_kf[slots] = 1
        self.point_recent[slots] = True

        pose0 = np.zeros(6)
        pose1 = np.concatenate([np_matrix_to_rotvec(r21), t21])
        kf0_map = np.full(kp0.shape[0], -1, np.int32)
        kf0_map[src_rows] = slots
        kf1_map = np.full(kp_norm.shape[0], -1, np.int32)
        kf1_map[idx[src_rows]] = slots
        self.keyframes = [
            Keyframe(pose0, kp0, d0, v0, kf0_map, n_new, kf_id=0,
                     kp_level=np.asarray(prev.level, np.int32),
                     kp_angle=np.asarray(prev.angle, np.float32)),
            Keyframe(pose1, kp_norm, desc, valid, kf1_map, n_new, kf_id=1,
                     kp_level=np.asarray(frame.level, np.int32),
                     kp_angle=np.asarray(frame.angle, np.float32)),
        ]
        self._next_kf_id = 2
        self.trajectory.append(FramePose(fid0, t0, pose0, ref_kf_id=0, rel6=np.zeros(6)))
        self.trajectory.append(
            FramePose(frame_id, time_usec, pose1, ref_kf_id=1, rel6=np.zeros(6))
        )
        self._pose = pose1
        self._motion = self._pose_delta(pose0, pose1)
        self._frames_since_keyframe = 0
        self._refresh_local_points()
        self.state = OK

    @staticmethod
    def _pose_delta(prev6, curr6):
        """delta such that curr = delta o prev (world->camera composition)."""
        r_prev = np_rotvec_to_matrix(prev6[:3])
        r_curr = np_rotvec_to_matrix(curr6[:3])
        r_d = r_curr @ r_prev.T
        t_d = curr6[3:] - r_d @ prev6[3:]
        return np.concatenate([np_matrix_to_rotvec(r_d), t_d])

    @staticmethod
    def _compose(delta6, pose6):
        r_d = np_rotvec_to_matrix(delta6[:3])
        r_p = np_rotvec_to_matrix(pose6[:3])
        return np.concatenate(
            [np_matrix_to_rotvec(r_d @ r_p), r_d @ pose6[3:] + delta6[3:]]
        )

    # --------------------------------------------------------------- track
    def _track_attempt(self, predicted, frame: _FrameFeatures):
        """Projected matching + robust pose refinement around a pose guess,
        against the compact local mirror. Returns (pose6, num_inliers,
        match_idx, inliers, in_view) as host values indexed by arena slot."""
        points_dev, desc_dev, cand_dev, level_dev = self._device_map()
        packed = fused_track_step(
            points_dev, desc_dev, cand_dev, level_dev,
            self._t(predicted),
            self._t(frame.kp_norm), self._t(frame.desc), self._t(frame.valid),
            self._t(frame.level),
            search_radius=self._search_rad,
            max_distance=matching.HAMMING_HIGH,
            scale=self.config.scale,
            level_window=self.config.level_window,
            refine_radius=self._refine_rad,
            huber_delta=self._huber,
            inlier_threshold=self._inlier_thresh,
        ).cpu().numpy()
        b = int(cand_dev.shape[0])
        n = self._dev_map_count
        rows = self._dev_map_sel[:n]
        m = self.config.max_map_points
        match_idx = np.full(m, -1, np.int32)
        match_idx[rows] = packed[7 : 7 + n].astype(np.int32)
        inliers = np.zeros(m, bool)
        inliers[rows] = packed[7 + b : 7 + b + n] > 0.5
        in_view = np.zeros(m, bool)
        in_view[rows] = packed[7 + 2 * b : 7 + 2 * b + n] > 0.5
        return packed[:6].astype(np.float64), int(packed[6]), match_idx, inliers, in_view

    def _track_reference_keyframe(self, frame: _FrameFeatures):
        """TrackReferenceKeyFrame (Tracking.cc:317-323, 748): descriptor-only
        matching against the newest keyframe's map-point observations, pose
        refined from the last pose. Returns a candidate pose6 or None."""
        kf = self.keyframes[-1]
        has_point = (kf.map_point >= 0) & kf.kp_valid
        has_point &= self.point_valid[np.clip(kf.map_point, 0, None)]
        if has_point.sum() < 8:
            return None
        kf_desc_dev, _ = self.kf_descriptors_device(kf)
        packed = fused_ref_kf_track(
            self._t(self.points[np.clip(kf.map_point, 0, None)]),
            self._t(has_point),
            kf_desc_dev,
            self._t(kf.kp_angle, torch.float32),
            self._t(kf.map_point),
            self._t(self._pose),
            self._t(frame.kp_norm),
            self._t(frame.desc),
            self._t(frame.valid),
            self._t(frame.level),
            self._t(frame.angle, torch.float32),
            scale=self.config.scale,
            use_rotation_check=self.config.rotation_consistency,
            huber_delta=self._huber,
            inlier_threshold=self._inlier_thresh,
        ).cpu().numpy()
        # Accepted at >= 10 inliers (Tracking.cc TrackReferenceKeyFrame);
        # guided local-map re-tracking must still confirm it.
        if int(packed[6]) < max(10, self.config.min_track_inliers // 2):
            return None
        return packed[:6].astype(np.float64)

    def _track(self, frame: _FrameFeatures, frame_id, time_usec):
        predicted = self._compose(self._motion, self._pose)
        new_pose, num_inliers, match_idx, inliers, in_front = (
            self._track_attempt(predicted, frame)
        )

        if (
            num_inliers < self.config.min_track_inliers
            and self.config.track_ref_kf_fallback
        ):
            # Motion-model tracking failed: retry against the reference
            # keyframe before relocalization (Tracking.cc:317-323).
            ref_pose = self._track_reference_keyframe(frame)
            if ref_pose is not None:
                pose2, n2, match_idx2, inliers2, in_front2 = (
                    self._track_attempt(ref_pose, frame)
                )
                if n2 >= self.config.min_track_inliers:
                    new_pose, match_idx, inliers = pose2, match_idx2, inliers2
                    in_front = in_front2
                    num_inliers = n2
                    self._motion = self._pose_delta(self._pose, new_pose)
                    self.stats["ref_kf_recoveries"] += 1

        if num_inliers < self.config.min_track_inliers:
            # Relocalization against the whole map before LOST; a
            # relocalized pose counts only if guided re-tracking around it
            # reaches full tracking quality.
            points_dev, map_desc_dev, map_valid_dev = self._device_map_full()
            reloc = relocalize(
                points_dev, map_desc_dev, map_valid_dev,
                self._t(frame.kp_norm), self._t(frame.desc), self._t(frame.valid),
                generator=self._generator,
            )
            accepted = False
            if int(reloc.num_inliers) >= max(8, self.config.min_track_inliers // 2):
                # Locality is stale around a global relocalization: re-track
                # (and track until the next keyframe) against the whole map.
                saved_local = self._local_points
                self._local_points = self.point_valid.copy()
                self._invalidate_device_map()
                pose2, n2, match_idx2, inliers2, in_front2 = self._track_attempt(
                    reloc.pose6.cpu().numpy().astype(np.float64), frame
                )
                if n2 >= self.config.min_track_inliers:
                    new_pose, match_idx, inliers = pose2, match_idx2, inliers2
                    in_front = in_front2
                    num_inliers = n2
                    self._motion = np.zeros(6)
                    accepted = True
                else:
                    self._local_points = saved_local
                    self._invalidate_device_map()
            if not accepted:
                self.state = LOST
                self._append_frame(frame_id, time_usec, self._pose.copy(), is_lost=True)
                return

        self._commit_tracked_frame(
            frame, frame_id, time_usec,
            new_pose, num_inliers, match_idx, inliers, in_front,
        )

    def _commit_tracked_frame(
        self, frame: _FrameFeatures, frame_id, time_usec,
        new_pose, num_inliers, match_idx, inliers, in_front,
    ):
        """Accept one tracked frame: per-point statistics, motion model,
        trajectory append, and the keyframe policy + insertion."""
        inliers = inliers & self.point_valid
        in_front = in_front & self.point_valid
        # MapPoint::IncreaseVisible / IncreaseFound.
        self.point_visible[in_front] += 1
        self.point_found[inliers] += 1
        self.last_track_kp_rows = match_idx[np.nonzero(inliers)[0]]

        self._motion = self._pose_delta(self._pose, new_pose)
        self._pose = new_pose
        self._append_frame(frame_id, time_usec, new_pose)
        self._frames_since_keyframe += 1

        ref_inliers = self.keyframes[-1].num_inliers or num_inliers
        need_keyframe = (
            num_inliers < self.config.keyframe_inlier_ratio * ref_inliers
            or self._frames_since_keyframe >= self.config.keyframe_max_gap
        )
        if not need_keyframe:
            return
        # Fold in the previous keyframe's deferred BA before new geometry
        # references the map.
        self._apply_pending_ba()
        kp_map = np.full(frame.kp_norm.shape[0], -1, np.int32)
        matched_points = np.nonzero(inliers)[0]
        kp_map[match_idx[matched_points]] = matched_points
        kf = Keyframe(
            new_pose.copy(), frame.kp_norm, frame.desc, frame.valid, kp_map,
            num_inliers, kf_id=self._next_kf_id,
            kp_level=np.asarray(frame.level, np.int32),
            kp_angle=np.asarray(frame.angle, np.float32),
        )
        self._next_kf_id += 1
        self.keyframes.append(kf)
        # Re-anchor the just-appended frame to the new keyframe.
        self.trajectory[-1].ref_kf_id = kf.kf_id
        self.trajectory[-1].rel6 = np.zeros(6)
        # Both sweeps are dispatched against the map as it stands now
        # (before culling), as in the reference's keyframe fan.
        create_dev = self._dispatch_create_points_all(kf)
        fuse_dev = self._dispatch_fuse(kf)
        self._map_point_culling(kf)
        self._create_new_points(kf, create_dev)
        self._fuse_duplicates(kf, fuse_dev)
        if self.config.ba_every_keyframe and len(self.keyframes) >= 3:
            self._local_bundle_adjust()
        self._keyframe_culling()
        self._refresh_local_points()
        self._frames_since_keyframe = 0

    # ----------------------------------------------------------- map growth
    def _create_pair_active(self, kf: Keyframe, prev: Keyframe) -> bool:
        """Gate for one (prev, kf) triangulation pair: a baseline of at least
        1% of the neighbour's median depth (LocalMapping.cc:246-259) and
        enough unmatched features on both sides."""
        pids = prev.map_point[prev.map_point >= 0]
        pids = pids[self.point_valid[pids]]
        if pids.size >= 10:
            r_prev = np_rotvec_to_matrix(prev.pose6[:3])
            depths = (self.points[pids] @ r_prev.T + prev.pose6[3:])[:, 2]
            median_depth = float(np.median(depths))
            c_prev = -(r_prev.T @ prev.pose6[3:])
            r_kf = np_rotvec_to_matrix(kf.pose6[:3])
            c_kf = -(r_kf.T @ kf.pose6[3:])
            baseline = float(np.linalg.norm(c_kf - c_prev))
            if median_depth > 0 and baseline / median_depth < 0.01:
                return False
        un_prev = prev.kp_valid & (prev.map_point < 0)
        un_curr = kf.kp_valid & (kf.map_point < 0)
        return bool(un_prev.sum() >= 8 and un_curr.sum() >= 8)

    def _dispatch_create_points_all(self, kf: Keyframe):
        """Triangulation of the new keyframe against its recent neighbours,
        closest first: one device program per active pair, results stacked
        into one [P, 5K] host copy. Returns (active_neighbors, packed) or
        ([], None)."""
        n = self.config.create_neighbor_kfs
        neighbors = self.keyframes[max(0, len(self.keyframes) - 1 - n) : -1]
        active = [p for p in reversed(neighbors) if self._create_pair_active(kf, p)]
        if not active:
            return [], None
        curr_desc_dev, _ = self.kf_descriptors_device(kf)
        curr = (
            curr_desc_dev,
            self._t(kf.kp_valid & (kf.map_point < 0)),
            self._t(kf.kp_norm),
            self._t(kf.kp_level),
            self._t(kf.kp_angle, torch.float32),
        )
        packs = []
        for prev in active:
            packs.append(
                create_points(
                    self.kf_descriptors_device(prev)[0],
                    self._t(prev.kp_valid & (prev.map_point < 0)),
                    self._t(prev.kp_norm),
                    self._t(prev.kp_level),
                    self._t(prev.kp_angle, torch.float32),
                    *curr,
                    self._t(self._pose_delta(prev.pose6, kf.pose6)),
                    self._t(prev.pose6),
                    min_parallax_cos=self.config.min_parallax_cos,
                    scale=self.config.scale,
                    use_rotation_check=self.config.rotation_consistency,
                    reproj_gate=self._reproj_gate,
                    epipolar_gate=self._epi_gate,
                )
            )
        return active, torch.stack(packs)

    def _create_new_points(self, kf: Keyframe, dispatched):
        """Commit the triangulated points pair by pair, closest neighbour
        first; a feature that gained a point from an earlier pair is skipped
        in later ones (first-wins dedup)."""
        active, handle = dispatched
        if handle is None:
            return
        k = kf.kp_norm.shape[0]
        packed_all = handle.cpu().numpy()
        for prev, packed in zip(active, packed_all):
            idx = packed[:k].astype(np.int32)
            good = packed[k : 2 * k] > 0.5
            pts_world_all = packed[2 * k :].reshape(k, 3).astype(np.float64)
            rows = np.nonzero(good)[0]
            if rows.size == 0:
                continue
            fresh = (kf.map_point[idx[rows]] < 0) & (prev.map_point[rows] < 0)
            rows = rows[fresh]
            if rows.size == 0:
                continue
            slots = self._free_slots(rows.size)
            take = len(slots)
            kp_rows = idx[rows[:take]]
            self.points[slots] = pts_world_all[rows][:take]
            self.point_desc[slots] = kf.descriptors[kp_rows]
            self.point_valid[slots] = True
            self.stats["points_created"] += take
            self.point_level[slots] = kf.kp_level[kp_rows]
            self.point_angle[slots] = kf.kp_angle[kp_rows]
            self.point_visible[slots] = 1
            self.point_found[slots] = 1
            self.point_first_kf[slots] = kf.kf_id
            self.point_recent[slots] = True
            prev.map_point[rows[:take]] = slots
            kf.map_point[kp_rows] = slots

    # ------------------------------------------------------ map maintenance
    def _map_point_culling(self, kf: Keyframe):
        """LocalMapping::MapPointCulling (LocalMapping.cc:170-206)."""
        recent = np.nonzero(self.point_recent & self.point_valid)[0]
        if recent.size == 0:
            return
        age = kf.kf_id - self.point_first_kf[recent]
        ratio = self.point_found[recent] / np.maximum(self.point_visible[recent], 1)
        obs = self._point_observations()[recent]
        bad = (ratio < self.config.cull_found_ratio) | (
            (age >= 2) & (obs <= self.config.cull_min_observations)
        )
        self._cull_points(recent[bad])
        graduated = recent[~bad][age[~bad] >= 3]
        self.point_recent[graduated] = False

    def _dispatch_fuse(self, kf: Keyframe):
        """Dispatch the fuse projection sweep of the local window's points
        not yet observed in ``kf`` against the compact mirror. Returns
        (sel, packed) or None when there are no candidates."""
        observed = np.zeros(self.config.max_map_points, bool)
        observed[kf.map_point[kf.map_point >= 0]] = True
        cand = self.point_valid & ~observed & self._local_points
        if not cand.any():
            return None
        points_dev, desc_dev, _, level_dev = self._device_map()
        sel, n = self._dev_map_sel, self._dev_map_count
        cand_b = np.zeros(int(points_dev.shape[0]), bool)
        cand_b[:n] = cand[sel[:n]]
        kf_desc_dev, _ = self.kf_descriptors_device(kf)
        packed = fused_project_match(
            points_dev, desc_dev, self._t(cand_b), level_dev,
            self._t(kf.pose6), kf_desc_dev,
            self._t(kf.kp_norm), self._t(kf.kp_valid), self._t(kf.kp_level),
            search_radius=self._fuse_rad,
            max_distance=matching.HAMMING_LOW,
            scale=self.config.scale,
            level_window=self.config.level_window,
        )
        return sel.copy(), packed

    def _fuse_duplicates(self, kf: Keyframe, dispatched):
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:454-525): a match
        onto a keypoint that already references a different point merges
        the two (the better-observed point wins); a match onto a free
        keypoint adds an observation. Candidates culled, or slots recycled
        for points created at this keyframe, since dispatch are dropped."""
        if dispatched is None:
            return
        sel, packed_dev = dispatched
        packed = packed_dev.cpu().numpy()
        m = packed.shape[0] // 2
        match_idx = packed[:m].astype(np.int32)
        pids = np.nonzero(packed[m:] > 0.5)[0]
        match_arena = np.full(self.config.max_map_points, -1, np.int32)
        match_arena[sel[pids]] = match_idx[pids]
        match_idx = match_arena
        pids = sel[pids]
        if pids.size:
            keep = self.point_valid[pids] & (self.point_first_kf[pids] != kf.kf_id)
            pids = pids[keep]
        if pids.size == 0:
            return
        obs_counts = self._point_observations()
        fused = 0
        for pid in pids:
            kp = int(match_idx[pid])
            existing = int(kf.map_point[kp])
            if existing < 0:
                kf.map_point[kp] = pid  # new observation of an old point
                continue
            if existing == pid or not self.point_valid[existing]:
                continue
            winner, loser = (
                (pid, existing)
                if obs_counts[pid] >= obs_counts[existing]
                else (existing, pid)
            )
            for other in self.keyframes:
                loser_rows = other.map_point == loser
                if not loser_rows.any():
                    continue
                # MapPoint::Replace drops the duplicate observation when the
                # keyframe already sees the winner.
                if (other.map_point == winner).any():
                    other.map_point[loser_rows] = -1
                else:
                    other.map_point[loser_rows] = winner
            self.point_found[winner] += self.point_found[loser]
            self.point_visible[winner] += self.point_visible[loser]
            self.point_valid[loser] = False
            self.point_recent[loser] = False
            self.point_first_kf[loser] = -1
            fused += 1
        self.stats["points_fused"] += fused

    def _keyframe_culling(self):
        """LocalMapping::KeyFrameCulling (LocalMapping.cc:631-695): drop a
        keyframe when >= 90% of its points are observed by at least 3 other
        keyframes (the first two and the newest two are exempt); frames
        anchored to it re-anchor to its predecessor."""
        if len(self.keyframes) < 4:
            return
        obs_counts = self._point_observations()
        for i in range(2, len(self.keyframes) - 2):
            kf = self.keyframes[i]
            pids = kf.map_point[kf.map_point >= 0]
            pids = pids[self.point_valid[pids]]
            if pids.size == 0:
                continue
            redundant = obs_counts[pids] >= self.config.keyframe_cull_min_obs + 1
            if redundant.sum() <= self.config.keyframe_cull_redundancy * pids.size:
                continue
            prev = self.keyframes[i - 1]
            delta_to_prev = self._pose_delta(prev.pose6, kf.pose6)
            for fp in self.trajectory:
                if fp.ref_kf_id == kf.kf_id and fp.rel6 is not None:
                    fp.rel6 = self._compose(fp.rel6, delta_to_prev)
                    fp.ref_kf_id = prev.kf_id
            self._kf_desc_dev.pop(kf.kf_id, None)
            del self.keyframes[i]
            self.stats["keyframes_culled"] += 1
            return  # at most one cull per keyframe insertion

    # ------------------------------------------------------------- local BA
    def _local_bundle_adjust(self):
        window = self.keyframes[-self.config.local_window :]
        pad_poses_to = self.config.local_window
        inv_scale = 1.0 / self.config.scale
        ki_parts, pid_parts, uv_parts, invs_parts = [], [], [], []
        for ki, kf in enumerate(window):
            rows = np.nonzero(kf.map_point >= 0)[0]
            kf_pids = kf.map_point[rows]
            ok = self.point_valid[kf_pids]
            rows, kf_pids = rows[ok], kf_pids[ok]
            ki_parts.append(np.full(rows.size, ki, np.int64))
            pid_parts.append(kf_pids)
            uv_parts.append(kf.kp_norm[rows])
            invs_parts.append(inv_scale ** kf.kp_level[rows].astype(np.float64))
        pid_cat = np.concatenate(pid_parts)
        # Local point ids in first-appearance order.
        uniq, first_idx, inverse = np.unique(
            pid_cat, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        obs_pose = np.concatenate(ki_parts)
        obs_point = rank[inverse]
        obs_uv = np.concatenate(uv_parts)
        obs_invs = np.concatenate(invs_parts)
        if uniq.size < 10 or obs_uv.shape[0] < 30:
            return
        pids = uniq[order]

        # Padded to fixed buckets, as the reference (its compiled shapes).
        def bucket(n, step):
            return -(-n // step) * step

        poses = np.stack([kf.pose6 for kf in window])
        if poses.shape[0] < pad_poses_to:
            poses = np.concatenate(
                [poses, np.repeat(poses[-1:], pad_poses_to - poses.shape[0], axis=0)]
            )
        num_m = bucket(len(pids), 256)
        pts = np.zeros((num_m, 3))
        pts[: len(pids)] = self.points[pids]
        pts[len(pids):, 2] = 1.0  # benign padding in front of the camera
        point_valid = np.zeros(num_m, bool)
        point_valid[: len(pids)] = True
        num_obs = obs_uv.shape[0]
        num_o = bucket(num_obs, 1024)
        o_pose = np.zeros(num_o, np.int64)
        o_point = np.zeros(num_o, np.int64)
        o_uv = np.zeros((num_o, 2))
        o_valid = np.zeros(num_o, bool)
        o_invs = np.ones(num_o)
        o_pose[:num_obs] = obs_pose
        o_point[:num_obs] = obs_point
        o_uv[:num_obs] = obs_uv
        o_valid[:num_obs] = True
        o_invs[:num_obs] = obs_invs

        problem = BAProblem(
            self._t(poses), self._t(pts), self._t(o_pose), self._t(o_point),
            self._t(o_uv), self._t(o_valid), self._t(point_valid), self._t(o_invs),
        )
        result = bundle_adjust(
            problem, huber_delta=self._huber, inlier_threshold=self._inlier_thresh,
        )
        self._pending_ba = (result, list(window), pids)
        if not self.config.ba_async:
            # Synchronous apply: the live pose follows the refined newest
            # keyframe (the window always ends at it).
            self._apply_pending_ba()
            self._pose = window[-1].pose6.copy()

    def _apply_pending_ba(self):
        """Fold a deferred local-BA result into the map: keyframe poses by
        object identity, refined points that are still valid. Called only
        where new geometry derives from the map (keyframe insertion,
        finalize, trajectory export), so frames between two keyframes track
        on geometry at most one BA window stale — the reference's
        Tracking-vs-LocalMapping lag."""
        if self._pending_ba is None:
            return
        result, window, pids = self._pending_ba
        self._pending_ba = None
        new_poses = result.poses6.cpu().numpy().astype(np.float64)
        for ki, kf in enumerate(window):
            kf.pose6 = new_poses[ki]
        live = self.point_valid[pids]
        new_points = result.points.cpu().numpy().astype(np.float64)[: len(pids)]
        self.points[pids[live]] = new_points[live]
        self._invalidate_device_map()
