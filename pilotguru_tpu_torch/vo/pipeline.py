"""optical_trajectories pipeline: video -> per-segment trajectory JSONs
(port of pilotguru_tpu/vo/pipeline.py).

Run monocular odometry until tracking is LOST, post-process the segment
(optional quaternion smoothing, translation PCA with the flatness test,
planar headings, turn angles), write trajectory-N.json, then restart a
fresh tracker on the remaining video (reference
src/optical_trajectories.cc:73-111 + src/slam/track_image_sequence.cc).

Each frame's features are extracted on the tracker's device, one frame at
a time, then tracked.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from pilotguru_tpu_torch.formats.trajectory import Trajectory, write_trajectory
from pilotguru_tpu_torch.timeseries.smoothing import smooth_quaternion_sequence
from pilotguru_tpu_torch.vo.camera import CameraSettings
from pilotguru_tpu_torch.vo.flatten import flatten_trajectory
from pilotguru_tpu_torch.vo.tracking import (
    LOST,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)


@dataclass
class VideoFrame:
    gray: np.ndarray  # [H, W] uint8 (preferred) or float32 in [0, 1]
    frame_id: int
    time_usec: int


def video_frames(
    video_path: str,
    vertical_flip: bool = False,
    horizontal_flip: bool = False,
    scale: float = 1.0,
) -> Iterator[VideoFrame]:
    """Decode a ride video (or a TUM-style image list) to grayscale uint8
    frames with timestamps, by video/io.py's routes (a PNG image list, the
    native libav reader, cv2 last); the gray conversion and the INTER_AREA
    resize are video/imgproc.py's, bit-equal to cv2's."""
    from pilotguru_tpu_torch.video.imgproc import resize_area, rgb_to_gray
    from pilotguru_tpu_torch.video.io import read_frames_rgb

    for frame_id, time_usec, rgb in read_frames_rgb(video_path, vertical_flip,
                                                    horizontal_flip):
        gray = rgb_to_gray(rgb)
        if scale != 1.0:
            gray = resize_area(gray, fx=scale, fy=scale)
        yield VideoFrame(gray, frame_id, time_usec)


def tracker_from_settings(
    settings: CameraSettings,
    image_scale: float = 1.0,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    patch_impl: str = "blur_then_gather",
) -> MonocularTracker:
    camera = CameraModel(
        fx=settings.fx * image_scale,
        fy=settings.fy * image_scale,
        cx=settings.cx * image_scale,
        cy=settings.cy * image_scale,
        # Distortion acts on the normalized plane: invariant to image_scale.
        k1=settings.k1,
        k2=settings.k2,
        p1=settings.p1,
        p2=settings.p2,
    )
    config = TrackerConfig(
        total_budget=settings.orb_features,
        num_levels=settings.orb_levels,
        fast_threshold=settings.orb_ini_th_fast / 255.0,
        patch_impl=patch_impl,
    )
    return MonocularTracker(camera, config, device=device, dtype=dtype)


def trajectory_from_tracker(tracker: MonocularTracker) -> Optional[Trajectory]:
    """Absolute poses rebuilt from the current keyframe poses
    (System::GetTrajectory); None for segments under 10 tracked frames."""
    frames = [fp for fp in tracker.final_trajectory() if not fp.is_lost]
    if len(frames) < 10:
        return None
    return Trajectory(
        time_usec=np.asarray([fp.time_usec for fp in frames], np.int64),
        frame_id=np.asarray([fp.frame_id for fp in frames], np.int64),
        is_lost=np.zeros(len(frames), bool),
        translations=np.stack([fp.camera_center() for fp in frames]),
        rotations=np.stack([fp.camera_to_world_quat() for fp in frames]),
    )


def postprocess_segment(
    trajectory: Trajectory, rotation_smooth_sigma: int = 0, device="cuda",
) -> Optional[Trajectory]:
    """Smoothing (on ``device``) + PCA flattening
    (track_image_sequence.cc:63-110). Returns None if the segment fails the
    flatness test."""
    if rotation_smooth_sigma > 0:
        trajectory.rotations = smooth_quaternion_sequence(
            trajectory.rotations, rotation_smooth_sigma, device=device
        ).cpu().numpy()
    result = flatten_trajectory(trajectory)
    if result is None:
        return None
    trajectory.plane, trajectory.planar_directions, trajectory.turn_angles = result
    return trajectory


def track_video_segments(
    frames: Iterable[VideoFrame],
    settings: CameraSettings,
    out_dir: str,
    rotation_smooth_sigma: int = 0,
    image_scale: float = 1.0,
    per_segment_videos: bool = False,
    visualize: bool = False,
    live_view_port: Optional[int] = None,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    stage_seconds: Optional[dict] = None,
    patch_impl: str = "blur_then_gather",
) -> Tuple[int, int]:
    """Segment loop (optical_trajectories.cc:91-111): fresh tracker per
    segment, restart after LOST, one JSON per valid segment. Returns
    (segments_written, frames_consumed).

    ``stage_seconds``: when given, host seconds spent extracting features
    (``"extract"``) and tracking (``"track"``) accumulate into it; both
    stages end in a device-to-host copy, so the host clock covers the
    device work. ``patch_impl``: the extractor's blurred-patch path
    (TrackerConfig.patch_impl)."""
    if per_segment_videos or visualize or live_view_port is not None:
        raise NotImplementedError(
            "--output_per_segment_videos, --visualize and --visualize_live_port "
            "are not ported to pilotguru_tpu_torch yet (ROADMAP.md, Queue 1)"
        )
    os.makedirs(out_dir, exist_ok=True)
    stages = stage_seconds if stage_seconds is not None else {}
    stages.setdefault("extract", 0.0)
    stages.setdefault("track", 0.0)

    frames = iter(frames)
    segment = 0
    consumed = 0
    exhausted = False
    while not exhausted:
        tracker = tracker_from_settings(settings, image_scale, device, dtype, patch_impl)
        fed = 0
        for frame in frames:
            t0 = time.perf_counter()
            kp_norm, desc, valid, kp_level, kp_angle = tracker.features(frame.gray)
            t1 = time.perf_counter()
            state = tracker.process_features(
                kp_norm, desc, valid, frame.frame_id, frame.time_usec,
                kp_level, kp_angle,
            )
            stages["extract"] += t1 - t0
            stages["track"] += time.perf_counter() - t1
            consumed += 1
            fed += 1
            if state == LOST:
                break
        else:
            exhausted = True
        tracker.finalize()
        trajectory = trajectory_from_tracker(tracker)
        if trajectory is not None:
            processed = postprocess_segment(trajectory, rotation_smooth_sigma, device)
            if processed is not None:
                write_trajectory(
                    processed, os.path.join(out_dir, f"trajectory-{segment:04d}.json")
                )
                segment += 1
            else:
                print(
                    f"segment with {len(trajectory)} tracked frames rejected "
                    "by the trajectory-plane flatness test (not planar)"
                )
        if fed == 0:
            break
    return segment, consumed
