"""optical_trajectories pipeline: video -> per-segment trajectory JSONs
(port of pilotguru_tpu/vo/pipeline.py).

Run monocular odometry until tracking is LOST, post-process the segment
(optional quaternion smoothing, translation PCA with the flatness test,
planar headings, turn angles), write trajectory-N.json, then restart a
fresh tracker on the remaining video (reference
src/optical_trajectories.cc:73-111 + src/slam/track_image_sequence.cc).

Each frame's features are extracted on the tracker's device, one frame at
a time, then tracked. The three visualization options (per-segment videos,
overlay videos, the live HTTP view of vo/viewer.py) only read the tracker
after each frame, so they leave the trajectory as it is; they draw and
encode with cv2 and do not run where cv2 is missing.
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
from pilotguru_tpu_torch.video.io import VideoWriterRgb, require_cv2
from pilotguru_tpu_torch.vo.camera import CameraSettings
from pilotguru_tpu_torch.vo.flatten import flatten_trajectory
from pilotguru_tpu_torch.vo.tracking import (
    LOST,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)


# Frame rate of the per-segment and overlay videos (the JAX package's).
VIDEO_FPS = 30.0


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


def gray_as_u8(gray: np.ndarray) -> np.ndarray:
    if gray.dtype == np.uint8:
        return gray
    return np.clip(gray * 255.0, 0.0, 255.0).astype(np.uint8)


def _overlay_frame(gray, tracker, frame_id, kp_norm, valid, state, rows):
    """The tracked-feature overlay of one frame, BGR uint8 (the headless
    stand-in for the reference's FrameDrawer window): detected keypoints as
    dots, the keypoints tracked as map-point inliers (``rows``) as circles,
    and a status line. Needs cv2."""
    import cv2

    img = cv2.cvtColor(gray_as_u8(gray), cv2.COLOR_GRAY2BGR)
    pix = tracker.camera.denormalize(np.asarray(kp_norm))
    h, w = gray.shape
    for x, y in pix[np.asarray(valid)]:
        if 0 <= x < w and 0 <= y < h:
            cv2.circle(img, (int(x), int(y)), 1, (0, 160, 0), -1)
    if state == OK and rows.size:
        for x, y in pix[rows]:
            if 0 <= x < w and 0 <= y < h:
                cv2.circle(img, (int(x), int(y)), 4, (0, 0, 230), 1)
    text = (f"f{frame_id} {state} inl={rows.size} "
            f"map={int(tracker.point_valid.sum())} kfs={len(tracker.keyframes)}")
    cv2.putText(img, text, (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    return img


def _remapped_to_segment_video(trajectory: Trajectory, first_ok_fid: int) -> Trajectory:
    """The entries from the first OK frame on: the init reference frame has
    no frame in the segment video."""
    keep = trajectory.frame_id >= first_ok_fid
    if keep.all():
        return trajectory
    return Trajectory(
        time_usec=trajectory.time_usec[keep],
        frame_id=trajectory.frame_id[keep],
        is_lost=trajectory.is_lost[keep],
        translations=trajectory.translations[keep],
        rotations=trajectory.rotations[keep],
        plane=trajectory.plane,
        planar_directions=(trajectory.planar_directions[keep]
                           if trajectory.planar_directions is not None else None),
        turn_angles=(trajectory.turn_angles[keep]
                     if trajectory.turn_angles is not None else None),
    )


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
    (TrackerConfig.patch_impl).

    ``per_segment_videos`` writes trajectory-NNNN.mp4 beside each
    trajectory JSON with exactly the OK-tracked frames, and remaps the
    JSON's frame ids to index that video (the reference's
    --output_per_segment_videos, optical_trajectories.cc:53-57 and
    track_image_sequence.cc:58-60,103-104: frame_id_offset is the first OK
    frame's id, and the entries before it, the initialization's reference
    frame, are dropped). ``visualize`` writes visualize-NNNN.mp4, every
    frame of the segment with its overlay (``_overlay_frame``). Both videos
    take the accepted segment's number and are removed for a rejected
    segment. ``live_view_port`` serves the overlay and the map over HTTP
    while the ride tracks (vo/viewer.py; 0 binds a free port, printed at
    the start). The videos run at VIDEO_FPS."""
    if per_segment_videos or visualize or live_view_port is not None:
        require_cv2("optical_trajectories --output_per_segment_videos / --visualize / "
                    "--visualize_live_port")
    os.makedirs(out_dir, exist_ok=True)
    stages = stage_seconds if stage_seconds is not None else {}
    stages.setdefault("extract", 0.0)
    stages.setdefault("track", 0.0)
    viewer = None
    if live_view_port is not None:
        from pilotguru_tpu_torch.vo.viewer import LiveViewer

        viewer = LiveViewer(live_view_port)
        print(f"live tracker view: http://localhost:{viewer.port}/")

    frames = iter(frames)
    segment = 0
    raw_segment = 0  # counts rejected segments too (the videos' working names)
    consumed = 0
    exhausted = False
    try:
        while not exhausted:
            tracker = tracker_from_settings(settings, image_scale, device, dtype, patch_impl)
            fed = 0
            first_ok_fid = None
            videos = {}  # "trajectory" / "visualize" -> (path, writer)

            def write(kind, rgb):
                if kind not in videos:
                    path = os.path.join(out_dir, f"{kind}-{raw_segment:04d}.mp4")
                    videos[kind] = (path, VideoWriterRgb(path, VIDEO_FPS))
                videos[kind][1].consume(rgb)

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
                if state == OK:
                    if first_ok_fid is None:
                        first_ok_fid = frame.frame_id
                    if per_segment_videos:
                        write("trajectory", np.repeat(gray_as_u8(frame.gray)[..., None], 3, 2))
                if visualize or viewer is not None:
                    rows = tracker.last_track_kp_rows
                    overlay = _overlay_frame(frame.gray, tracker, frame.frame_id, kp_norm,
                                             valid, state, rows)
                    if visualize:
                        write("visualize", overlay[..., ::-1])
                    if viewer is not None:
                        viewer.publish_frame(overlay)
                        viewer.publish_state(tracker, frame.frame_id, state, rows.size)
                if state == LOST:
                    break
            else:
                exhausted = True
            tracker.finalize()
            for _, writer in videos.values():
                writer.close()
            trajectory = trajectory_from_tracker(tracker)
            accepted = False
            if trajectory is not None:
                processed = postprocess_segment(trajectory, rotation_smooth_sigma, device)
                if processed is not None:
                    offset = 0
                    if per_segment_videos and first_ok_fid is not None:
                        offset = int(first_ok_fid)
                        processed = _remapped_to_segment_video(processed, offset)
                    write_trajectory(
                        processed, os.path.join(out_dir, f"trajectory-{segment:04d}.json"),
                        frame_id_offset=offset,
                    )
                    for kind, (path, _) in videos.items():
                        want = os.path.join(out_dir, f"{kind}-{segment:04d}.mp4")
                        if want != path:
                            os.replace(path, want)
                    segment += 1
                    accepted = True
                else:
                    print(
                        f"segment with {len(trajectory)} tracked frames rejected "
                        "by the trajectory-plane flatness test (not planar)"
                    )
            if not accepted:
                # trajectory-N.mp4 always pairs with trajectory-N.json.
                for path, _ in videos.values():
                    if os.path.exists(path):
                        os.remove(path)
            raw_segment += 1
            if fed == 0:
                break
    finally:
        if viewer is not None:
            viewer.close()
    return segment, consumed
