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

from pilotguru_tpu.formats.trajectory import Trajectory, write_trajectory
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
    frames with timestamps: the native libav reader of pilotguru_tpu.video
    when it is built, else cv2 (imported here, not at module import)."""
    import cv2

    from pilotguru_tpu.video import native as native_video
    from pilotguru_tpu.video.io import is_image_list, read_image_list_rgb

    def gray_of(rgb):
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        if scale != 1.0:
            gray = cv2.resize(gray, None, fx=scale, fy=scale,
                              interpolation=cv2.INTER_AREA)
        return gray

    if is_image_list(video_path):
        for frame_id, time_usec, rgb in read_image_list_rgb(
            video_path, vertical_flip, horizontal_flip
        ):
            yield VideoFrame(gray_of(rgb), frame_id, time_usec)
        return

    if native_video.available():
        with native_video.NativeVideoReader(
            video_path, vertical_flip, horizontal_flip
        ) as reader:
            for frame_id, (rgb, pts_usec) in enumerate(reader):
                yield VideoFrame(gray_of(rgb), frame_id, pts_usec)
        return

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frame_id = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            if scale != 1.0:
                gray = cv2.resize(gray, None, fx=scale, fy=scale,
                                  interpolation=cv2.INTER_AREA)
            if vertical_flip:
                gray = gray[::-1]
            if horizontal_flip:
                gray = gray[:, ::-1]
            msec = cap.get(cv2.CAP_PROP_POS_MSEC)
            time_usec = int(msec * 1000) if msec > 0 else int(frame_id / fps * 1e6)
            yield VideoFrame(np.ascontiguousarray(gray), frame_id, time_usec)
            frame_id += 1
    finally:
        cap.release()


def tracker_from_settings(
    settings: CameraSettings,
    image_scale: float = 1.0,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
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
    trajectory: Trajectory, rotation_smooth_sigma: int = 0
) -> Optional[Trajectory]:
    """Smoothing + PCA flattening (track_image_sequence.cc:63-110). Returns
    None if the segment fails the flatness test."""
    if rotation_smooth_sigma > 0:
        trajectory.rotations = smooth_quaternion_sequence(
            trajectory.rotations, rotation_smooth_sigma
        ).numpy()
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
) -> Tuple[int, int]:
    """Segment loop (optical_trajectories.cc:91-111): fresh tracker per
    segment, restart after LOST, one JSON per valid segment. Returns
    (segments_written, frames_consumed).

    ``stage_seconds``: when given, host seconds spent extracting features
    (``"extract"``) and tracking (``"track"``) accumulate into it; both
    stages end in a device-to-host copy, so the host clock covers the
    device work."""
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
        tracker = tracker_from_settings(settings, image_scale, device, dtype)
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
            processed = postprocess_segment(trajectory, rotation_smooth_sigma)
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
