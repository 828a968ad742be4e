"""optical_trajectories pipeline: video -> per-segment trajectory JSONs
(port of pilotguru_tpu/vo/pipeline.py).

Run monocular odometry until tracking is LOST, post-process the segment
(optional quaternion smoothing, translation PCA with the flatness test,
planar headings, turn angles), write trajectory-N.json, then restart a
fresh tracker on the remaining video (reference
src/optical_trajectories.cc:73-111 + src/slam/track_image_sequence.cc).

As the reference's CLI runs it: frames decode on a thread of their own
(``background_frames``), their features are extracted in batches on a
worker thread one batch ahead of the tracker (``prefetch_features``), and
the tracker takes chunks of frames between keyframe decisions
(MonocularTracker.process_chunk). ``feature_batch_size=0`` and a tracker
with ``track_chunk_frames=0`` track frame by frame with the features
extracted inline. The three visualization options (per-segment videos, overlay
videos, the live HTTP view of vo/viewer.py) only read the tracker after
each frame, so they leave the trajectory as it is; they draw and encode
with cv2 and do not run where cv2 is missing.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from pilotguru_tpu_torch.formats.trajectory import Trajectory, write_trajectory
from pilotguru_tpu_torch.timeseries.smoothing import smooth_quaternion_sequence
from pilotguru_tpu_torch.video.io import VideoWriterRgb, require_cv2
from pilotguru_tpu_torch.vo.camera import CameraSettings
from pilotguru_tpu_torch.vo.features import extract_orb_features_batch
from pilotguru_tpu_torch.vo.flatten import flatten_trajectory
from pilotguru_tpu_torch.vo.tracking import (
    LOST,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
    device_images,
    host_features,
    pack_features,
)


# Frame rate of the per-segment and overlay videos (the JAX package's).
VIDEO_FPS = 30.0


@dataclass
class VideoFrame:
    gray: np.ndarray  # [H, W] uint8 (preferred) or float32 in [0, 1]
    frame_id: int
    time_usec: int
    # The frame's features as MonocularTracker.process_features takes them
    # (kp_norm, desc, valid, level, angle): host arrays, but for the
    # prefetcher's descriptors, which stay on the device. None until
    # extracted.
    features: Optional[tuple] = None
    # The prefetcher's (kp_norm, desc, valid, level) rows on the device,
    # which the chunked tracker takes without another upload.
    dev_features: Optional[tuple] = None


def _threaded(items: Iterable, maxsize: int, name: str) -> Iterator:
    """Iterate ``items`` on a daemon worker thread through a queue of at
    most ``maxsize`` items. An exception in the worker is raised again in
    the consumer; closing this generator stops the worker at its next
    item."""
    out: queue.Queue = queue.Queue(maxsize=maxsize)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def run():
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except Exception as exc:  # raised again in the consumer
            put(exc)

    threading.Thread(target=run, daemon=True, name=name).start()
    try:
        while True:
            item = out.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def background_frames(frames: Iterable[VideoFrame], maxsize: int = 16) -> Iterator[VideoFrame]:
    """Decode on a daemon thread of its own, so that decoding overlaps the
    device work (the reference decodes inline on its tracking thread,
    image_sequence_reader.cc). Exceptions are raised again in the
    consumer."""
    return _threaded(frames, maxsize, "frame-decode")


def _extract_batch(grays, camera: CameraModel, config: TrackerConfig, device):
    """One batch's features on the device: (packed [B, K, 5] float32, see
    tracking.pack_features; kp_norm [B, K, 2]; desc [B, K, 256]; valid
    [B, K]; level [B, K]). Each frame launches the extractor's kernels once,
    as a frame extracted alone."""
    kps = extract_orb_features_batch(
        device_images(np.stack([np.asarray(g) for g in grays]), device),
        num_levels=config.num_levels,
        scale=config.scale,
        threshold=config.fast_threshold,
        total_budget=config.total_budget,
        patch_impl=config.patch_impl,
    )
    packed, kp_norm = pack_features(kps, camera)
    return packed, kp_norm, kps.descriptors, kps.valid, kps.level


def _start_host_copy(tensor: torch.Tensor):
    """(host tensor, event): a copy of ``tensor`` into pinned host memory,
    queued behind the work that makes it. The host tensor may be read only
    after ``event.synchronize()``; the event is None for a CPU tensor, which
    is its own host copy."""
    if tensor.device.type == "cpu":
        return tensor, None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensor.device))
    return host, event


def _device_list(devices, device) -> list:
    """prefetch_features' devices as a list of torch.device: ``device``
    (one) or ``devices`` (one, or a sequence), else every visible card."""
    if device is not None:
        if devices is not None:
            raise ValueError("prefetch_features: give devices or device, not both")
        devices = device
    if devices is None:
        from pilotguru_tpu_torch.parallel.mesh import cuda_devices

        return cuda_devices()
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [_indexed(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("prefetch_features: an empty device list")
    return devices


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:<current>``)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on_stream(*streams):
    """The CUDA streams current on their devices within (None: a CPU
    device, nothing to set); the last one's device current."""
    stack = contextlib.ExitStack()
    for stream in streams:
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
    if streams and streams[-1] is not None:
        stack.enter_context(torch.cuda.device(streams[-1].device))
    return stack


def _move_rows(rows, src: torch.device, src_stream, home: torch.device, home_stream):
    """A shard's device rows on the tracker's device ``home``. From another
    card the copy is enqueued on ``home_stream`` behind an event recorded
    on the shard's stream, so it waits for the shard's extraction."""
    if src == home:
        return rows
    if src_stream is not None and home_stream is not None:
        ready = torch.cuda.Event()
        ready.record(src_stream)
        home_stream.wait_event(ready)
    with _on_stream(src_stream, home_stream):
        return [row.to(home, non_blocking=True) for row in rows]


def prefetch_features(
    frames: Iterable[VideoFrame],
    camera: CameraModel,
    config: TrackerConfig,
    batch_size: int = 8,
    devices=None,
    *,
    device=None,
) -> Iterator[VideoFrame]:
    """Yield ``frames`` with their ORB features attached (VideoFrame.features
    and .dev_features), extracted ``batch_size`` frames at a time with
    ``config``'s extractor settings (its ``patch_impl`` among them).

    ``devices``: one device, or a list of them (default: every visible
    card, as the JAX prefetcher takes every local device); ``device`` names
    one. Each batch splits into contiguous sub-batches, one a device
    (parallel/mesh.py's blocks: sizes differ by at most one, a short last
    batch included, never padded), each extracted on its device; every
    frame launches the extractor's kernels once, as a frame extracted
    alone. The descriptors and device rows (dev_features) land on the
    first device, the tracker's; frames come out in their input order.

    Keypoints are normalized on the device and every per-keypoint quantity
    of a sub-batch comes back in one packed array, copied to pinned host
    memory behind its work; the batches run one ahead, so batch k + 1 is
    launched before batch k's copies are read. Descriptors stay on the
    device: matching takes them there, and the tracker pulls a host copy
    only for a keyframe.

    The whole pipeline runs on a daemon worker thread feeding a bounded
    queue (three batches), on each card's current stream as the consumer
    sees it when it calls this, so the consumer's work and the worker's
    are ordered on the tracker's stream; a sub-batch's rows from another
    card reach that stream behind an event on its own (``_move_rows``). An
    exception in the worker is raised again in the consumer."""
    from pilotguru_tpu_torch.parallel.mesh import block_bounds

    devices = _device_list(devices, device)
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]
    home, home_stream = devices[0], streams[0]

    def batches():
        batch = []
        for frame in frames:
            batch.append(frame)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def launch(batch):
        shards = []
        for (lo, hi), dev, stream in zip(block_bounds(len(batch), len(devices)), devices,
                                         streams):
            if lo == hi:
                continue
            with _on_stream(stream):
                packed, *rows = _extract_batch([f.gray for f in batch[lo:hi]], camera, config,
                                               dev)
                copy = _start_host_copy(packed)
            shards.append((batch[lo:hi], copy, _move_rows(rows, dev, stream, home,
                                                          home_stream)))
        return shards

    def finish(shards):
        for batch, (host, event), (kp_norm, desc, valid, level) in shards:
            if event is not None:
                event.synchronize()
            # A copy out of the pinned buffer, which then returns to the
            # allocator (keyframes keep their keypoints for the whole ride).
            host = host.numpy().copy()
            for i, frame in enumerate(batch):
                frame.dev_features = (kp_norm[i], desc[i], valid[i], level[i])
                frame.features = host_features(host[i], frame.dev_features[1])
                yield frame

    def pipeline():
        in_flight = None
        for batch in batches():
            launched = launch(batch)
            if in_flight is not None:
                yield from finish(in_flight)
            in_flight = launched
        if in_flight is not None:
            yield from finish(in_flight)

    return _threaded(pipeline(), 3 * batch_size, "orb-prefetch")


def _prefetch_devices(tracker_device):
    """The devices the segment loop extracts features on: the tracker's
    first, then every other visible card when it is on one (as the JAX CLI
    extracts over every local device); the tracker's device alone on the
    CPU."""
    tracker_device = torch.device(tracker_device)
    if tracker_device.type != "cuda":
        return tracker_device
    from pilotguru_tpu_torch.parallel.mesh import cuda_devices

    home = _indexed(tracker_device)
    return [home] + [d for d in cuda_devices() if d != home]


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


def camera_and_config(
    settings: CameraSettings,
    image_scale: float = 1.0,
    patch_impl: str = "blur_then_gather",
    track_chunk_frames: int = TrackerConfig.track_chunk_frames,
) -> Tuple[CameraModel, TrackerConfig]:
    """The camera and the tracker configuration that ``settings`` give: the
    camera YAML's intrinsics and ORB budget, the reference CLI's tracker
    configuration otherwise."""
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
        track_chunk_frames=track_chunk_frames,
    )
    return camera, config


def tracker_from_settings(
    settings: CameraSettings,
    image_scale: float = 1.0,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    patch_impl: str = "blur_then_gather",
    track_chunk_frames: int = TrackerConfig.track_chunk_frames,
) -> MonocularTracker:
    """A fresh tracker with ``camera_and_config``'s camera and configuration;
    ``track_chunk_frames=0`` tracks frame by frame."""
    camera, config = camera_and_config(settings, image_scale, patch_impl, track_chunk_frames)
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
    make_tracker=None,
    feature_batch_size: int = 8,
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

    Frames decode on their own thread and their features are prefetched in
    batches of ``feature_batch_size`` (0 decodes and extracts inline, frame
    by frame), with the first tracker's camera and extractor settings on
    its device and, when that is a card, on every other visible card too
    (``_prefetch_devices``); a tracker whose ``track_chunk_frames`` is above 0 takes
    chunks of that many frames in the OK state. ``make_tracker``: a
    function returning a fresh tracker for each segment (default:
    ``tracker_from_settings`` with ``device``, ``dtype`` and
    ``patch_impl``). Frames read but not consumed when a segment ends go
    to the next segment's tracker.

    ``stage_seconds``: when given, accumulates the host seconds spent
    waiting for features (``"extract"``: the prefetch queue's wait, or the
    inline extraction) and tracking (``"track"``), both ending in a
    device-to-host copy, and the counts ``"chunks"`` (chunks dispatched),
    ``"chunk_frames"`` (frames they consumed) and ``"refed"`` (frames a
    chunk dispatched but left for the next). ``patch_impl``: the
    extractor's blurred-patch path (TrackerConfig.patch_impl).

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
    the start). The videos run at VIDEO_FPS; every consumed frame reaches
    them, chunked or not."""
    if per_segment_videos or visualize or live_view_port is not None:
        require_cv2("optical_trajectories --output_per_segment_videos / --visualize / "
                    "--visualize_live_port")
    os.makedirs(out_dir, exist_ok=True)
    stages = stage_seconds if stage_seconds is not None else {}
    for key, zero in (("extract", 0.0), ("track", 0.0), ("chunks", 0), ("chunk_frames", 0),
                      ("refed", 0)):
        stages.setdefault(key, zero)
    frames = iter(frames)
    prefetched = None
    if make_tracker is None:
        def make_tracker():
            return tracker_from_settings(settings, image_scale, device, dtype, patch_impl)

    viewer = None
    if live_view_port is not None:
        from pilotguru_tpu_torch.vo.viewer import LiveViewer

        viewer = LiveViewer(live_view_port)
        print(f"live tracker view: http://localhost:{viewer.port}/")

    segment = 0
    raw_segment = 0  # counts rejected segments too (the videos' working names)
    consumed = 0
    exhausted = False
    buf: list = []  # frames read (and prefetched) but not yet fed to a tracker
    try:
        while not exhausted or buf:
            tracker = make_tracker()
            if feature_batch_size > 0 and prefetched is None:
                # The prefetcher extracts with the first tracker's camera and
                # extractor settings (its patch_impl among them), on its
                # device first; no tracker is made for it alone.
                frames = prefetched = prefetch_features(
                    background_frames(frames), tracker.camera, tracker.config,
                    feature_batch_size, _prefetch_devices(tracker.device))
            chunk_size = tracker.config.track_chunk_frames
            fed = 0
            first_ok_fid = None
            videos = {}  # "trajectory" / "visualize" -> (path, writer)

            def write(kind, rgb):
                if kind not in videos:
                    path = os.path.join(out_dir, f"{kind}-{raw_segment:04d}.mp4")
                    videos[kind] = (path, VideoWriterRgb(path, VIDEO_FPS))
                videos[kind][1].consume(rgb)

            def handle_frame(frame, state, rows):
                nonlocal consumed, fed, first_ok_fid
                consumed += 1
                fed += 1
                if state == OK:
                    if first_ok_fid is None:
                        first_ok_fid = frame.frame_id
                    if per_segment_videos:
                        write("trajectory", np.repeat(gray_as_u8(frame.gray)[..., None], 3, 2))
                if visualize or viewer is not None:
                    kp_norm, _, valid = frame.features[:3]
                    overlay = _overlay_frame(frame.gray, tracker, frame.frame_id, kp_norm,
                                             valid, state, rows)
                    if visualize:
                        write("visualize", overlay[..., ::-1])
                    if viewer is not None:
                        viewer.publish_frame(overlay)
                        viewer.publish_state(tracker, frame.frame_id, state, rows.size)

            while True:
                t0 = time.perf_counter()
                while len(buf) < max(chunk_size, 1) and not exhausted:
                    frame = next(frames, None)
                    if frame is None:
                        exhausted = True
                    else:
                        buf.append(frame)
                t1 = time.perf_counter()
                stages["extract"] += t1 - t0
                if not buf:
                    break
                if tracker.state == OK and chunk_size > 0 and buf[0].features is not None:
                    # A chunk tracks against the map as it stands at its
                    # start, through a mid-chunk keyframe; it stops early at
                    # a tracking failure or at a frame that must become a
                    # keyframe from fresh-map results, and the rest stays in
                    # ``buf``.
                    dispatched = buf[:chunk_size]
                    results = tracker.process_chunk(dispatched)
                    stages["track"] += time.perf_counter() - t1
                    stages["chunks"] += 1
                    stages["chunk_frames"] += len(results)
                    stages["refed"] += len(dispatched) - len(results)
                    del buf[: len(results)]
                    for frame, (state, rows) in zip(dispatched, results):
                        handle_frame(frame, state, rows)
                else:
                    frame = buf.pop(0)
                    if frame.features is None:
                        extracting = tracker.feature_seconds
                        state = tracker.process_frame(frame.gray, frame.frame_id,
                                                      frame.time_usec)
                        frame.features = tracker.frame_features
                        extracted = tracker.feature_seconds - extracting
                        stages["extract"] += extracted
                        t1 += extracted
                    else:
                        kp_norm, desc, valid, kp_level, kp_angle = frame.features
                        state = tracker.process_features(
                            kp_norm, desc, valid, frame.frame_id, frame.time_usec,
                            kp_level, kp_angle,
                        )
                    stages["track"] += time.perf_counter() - t1
                    handle_frame(frame, state, tracker.last_track_kp_rows)
                if state == LOST:
                    break
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
        if prefetched is not None:
            prefetched.close()
        if viewer is not None:
            viewer.close()
    return segment, consumed
