"""predict_live CLI: realtime steering inference published over ZeroMQ
(port of pilotguru_tpu.cli.predict_live, the reference's
python/predict_live.py).

Camera or video frames -> crop / resize -> ensemble mean on the device ->
EMA -> {"s": degrees} on a ZMQ PUB socket with CONFLATE=1 (latest value
only): the wire contract the kia_steering_nn controller reads
(src/kia_steering_nn.cc:22-35, src/nn_comm/nn_comm.cc:53-55).

A file source (--in_video_file: a video file or a PNG image list,
video/io.py) is read frame by frame in the loop, so every frame is
predicted. A capture device (--in_video_device_id) is read by cv2 on a
daemon thread into a latest-value cell (utils/latest_value.py), so
inference always takes the freshest frame. The preview window
(--show_preview, cv2) is off by default; --log_dir writes video.mp4 (cv2)
and frames.json. A capture device, the preview and the log do not run
where cv2 is missing. The ensemble is ml/prediction.py's EnsemblePredictor
on the device of PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda), built
from the first frame's shape; the one host sync a frame is the
prediction's copy back. --cuda_device_id is accepted and ignored, and
--dtype is accepted for compatibility and unused, as in predict_video.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device
from pilotguru_tpu_torch.cli.predict_video import add_crop_args, load_predictor


def _capture_into(device_id: int, cell) -> None:
    """Read RGB frames from capture device ``device_id`` into ``cell``
    until the device stops (then publish None). Needs cv2."""
    import cv2

    capture = cv2.VideoCapture(device_id)
    if not capture.isOpened():
        cell.set(None)
        raise ValueError(f"cannot open capture device {device_id}")
    try:
        while True:
            ok, bgr = capture.read()
            if not ok:
                cell.set(None)
                return
            cell.set(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    finally:
        capture.release()


def _live_frames(device_id: int):
    """Yield the freshest RGB frame of a capture device, each once, read on a
    daemon thread through a latest-value cell."""
    import threading

    from pilotguru_tpu_torch.utils.latest_value import SynchronizedLatestValue

    cell = SynchronizedLatestValue()
    threading.Thread(target=_capture_into, args=(device_id, cell), daemon=True).start()
    update_id = 0
    while True:
        rgb, update_id = cell.get_next(update_id, timeout=5.0)
        if rgb is None:
            return
        yield rgb


def _show_preview(display_rgb) -> bool:
    """Show the model's input frame; True when the user pressed q. Needs
    cv2."""
    import cv2

    cv2.imshow("frame", cv2.cvtColor(display_rgb, cv2.COLOR_RGB2BGR))
    return cv2.waitKey(1) & 0xFF == ord("q")


def _close_preview() -> None:
    """Close the preview window. Needs cv2."""
    import cv2

    cv2.destroyAllWindows()


def main(argv=None, stats: Optional[dict] = None):
    """``stats``: when given, receives the frames predicted, the loop's
    seconds and the host seconds of each frame from its read to its send."""
    parser = make_parser(__doc__)
    parser.add_argument("--in_video_device_id", type=int, default=None)
    parser.add_argument("--in_video_file", default=None)
    parser.add_argument("--delay_max_fps", type=float, default=-1)
    parser.add_argument("--skip_max_fps", type=float, default=-1)
    parser.add_argument("--forward_axis_json", required=True)
    parser.add_argument("--net_settings_json", required=True)
    parser.add_argument("--in_model_weights", required=True)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--trajectory_frame_update_rate", type=float, default=1.0)
    parser.add_argument("--prediction_units_to_degrees_scale", type=float, default=90.0)
    parser.add_argument("--steering_prediction_socket", default="ipc:///tmp/steering-predict")
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--show_preview", type=bool, default=False)
    parser.add_argument(
        "--max_frames", type=int, default=-1,
        help="Stop after N frames (testing hook; <0 = run forever).",
    )
    add_crop_args(parser)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    if args.in_video_device_id is None and not args.in_video_file:
        parser.error("one of --in_video_device_id / --in_video_file is required")
    device, _ = setup_device(args.dtype)

    import numpy as np
    import zmq

    from pilotguru_tpu_torch.formats import json_io
    from pilotguru_tpu_torch.ml import models
    from pilotguru_tpu_torch.ml.prediction import (
        frame_to_model_input,
        update_future_trajectory_prediction,
    )
    from pilotguru_tpu_torch.video.io import VideoWriterRgb, read_frames_rgb, require_cv2

    if args.in_video_device_id is not None or args.log_dir or args.show_preview:
        require_cv2("predict_live (capture device, --log_dir, --show_preview)")
    net_settings = json_io.read_json(args.net_settings_json)
    forward_axis = json_io.read_forward_axis(args.forward_axis_json).astype(np.float32)[None, :]
    if args.in_video_device_id is not None:
        frames = _live_frames(args.in_video_device_id)
    else:
        frames = (rgb for _, _, rgb in read_frames_rgb(args.in_video_file))

    context = zmq.Context()
    socket = context.socket(zmq.PUB)
    # Latest value only: a stale prediction must never queue behind a fresh
    # one (predict_live.py:52-59).
    socket.setsockopt(zmq.CONFLATE, 1)
    socket.bind(args.steering_prediction_socket)

    log_writer = None
    log_frames = []
    if args.log_dir:
        import os

        os.makedirs(args.log_dir, exist_ok=True)
        log_writer = VideoWriterRgb(os.path.join(args.log_dir, "video.mp4"), 30.0)

    predictor = None
    trajectory = None
    frame_interval = 1.0 / args.delay_max_fps if args.delay_max_fps > 0 else 0.0
    skip_interval = 1.0 / args.skip_max_fps if args.skip_max_fps > 0 else 0.0
    last_time = 0.0
    last_kept = 0.0
    frames_done = 0
    host_seconds = []
    print("Live prediction started.")
    start = time.perf_counter()
    try:
        for frame in frames:
            if 0 <= args.max_frames <= frames_done:
                break
            read_at = time.perf_counter()
            now = time.time()
            if frame_interval > 0:
                remaining = frame_interval - (now - last_time)
                if remaining > 0:
                    time.sleep(remaining)
                now = time.time()
                read_at = time.perf_counter()
            last_time = now
            if skip_interval > 0 and (now - last_kept) < skip_interval:
                continue
            last_kept = now

            model_input, display = frame_to_model_input(
                frame,
                crop_top=args.crop_top,
                crop_bottom=args.crop_bottom,
                crop_left=args.crop_left,
                crop_right=args.crop_right,
                target_height=net_settings.get("target_height"),
                target_width=net_settings.get("target_width"),
                convert_to_yuv=args.convert_to_yuv,
            )
            if predictor is None:  # the nets' input widths come from the first frame
                predictor = load_predictor(net_settings, args.in_model_weights.split(","),
                                           model_input.shape[1:], device)
            prediction = predictor({models.FRAME_IMG: model_input,
                                    models.FORWARD_AXIS: forward_axis})
            trajectory = update_future_trajectory_prediction(
                trajectory, prediction, args.trajectory_frame_update_rate)
            degrees = float(trajectory[0, 0]) * args.prediction_units_to_degrees_scale
            socket.send_json({"s": degrees})
            host_seconds.append(time.perf_counter() - read_at)
            frames_done += 1

            if log_writer is not None:
                log_writer.consume(frame)
                log_frames.append({"frame_id": len(log_frames), "time_usec": int(now * 1e6)})
            if args.show_preview and _show_preview(display):
                break
    finally:
        seconds = time.perf_counter() - start
        socket.close(linger=1000)
        context.term()
        if log_writer is not None:
            log_writer.close()
            json_io.write_json({"frames": log_frames}, f"{args.log_dir}/frames.json")
        if args.show_preview:
            _close_preview()
    print(f"{frames_done} frames predicted in {seconds:.3f} s")
    if stats is not None:
        stats.update(frames=frames_done, seconds=seconds, host_seconds=host_seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
