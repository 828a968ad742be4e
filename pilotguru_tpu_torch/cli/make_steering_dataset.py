"""make_steering_dataset CLI: video + motion JSONs -> npz training examples.

Flag- and format-compatible with pilotguru_tpu.cli.make_steering_dataset
(the reference's python/make_steering_dataset.py): per-frame annotation of
the steering and velocity series (in-process, the port's timeseries
modules), the frame_id zipper-join, CAN/IMU unit normalisation (degrees/90
against inverse radius x 28 with the +1 m/s velocity regulariser), the
history/lookahead ring buffer with its invalidation on gaps, excluded and
slow frames, and frame-%06d-data.npz files of CHW uint8 images, lookahead
steering labels and the ride's forward axis. Multi-frame histories are
written as [F, C, H, W] arrays (the JAX package's fix over the reference).

Frames come through video/io.py's routes (a PNG image list needs no
codec); crop, INTER_AREA resize and YUV are video/imgproc.py's, bit-equal
to cv2's; the gray conversion is the JAX CLI's numpy weights; the PNG
written every --save_png_every examples is video/png.py's. The device
comes from PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda); ``--dtype``
is the annotation's precision (auto: float64 on the CPU, float32 on CUDA).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device

CAN = "can"
IMU = "imu"
CAN_DEGREES_TO_STEERING_UNITS = 1.0 / 90.0
INVERSE_RADIUS_METERS_TO_STEERING_UNITS = 28.0
STEERING_VALUE_BY_SOURCE = {IMU: "angular_velocity", CAN: "steering_angle_degrees"}
SMOOTHING_BY_SOURCE = {IMU: 0.1, CAN: -1.0}
GRAY_WEIGHTS = np.array([0.2989, 0.5870, 0.1140]).reshape(1, 1, 3)


def join_frame_data(steering_events, velocity_events, steering_source):
    """Zipper-join two frame-id-sorted event lists; unmatched sides yield
    None fields (make_steering_dataset.py:88-109)."""
    value_key = STEERING_VALUE_BY_SOURCE[steering_source]
    out = []
    si = vi = 0
    while si < len(steering_events) or vi < len(velocity_events):
        s = steering_events[si] if si < len(steering_events) else None
        v = velocity_events[vi] if vi < len(velocity_events) else None
        if s is not None and v is not None:
            if s["frame_id"] < v["frame_id"]:
                v = None
            elif s["frame_id"] > v["frame_id"]:
                s = None
        frame_id = v["frame_id"] if v is not None else s["frame_id"]
        out.append((frame_id, s[value_key] if s is not None else None,
                    v["speed_m_s"] if v is not None else None))
        if s is not None:
            si += 1
        if v is not None:
            vi += 1
    return out


def steering_labels(raw_steering, velocities, steering_source):
    """Unit normalisation (make_steering_dataset.py:182-190)."""
    if steering_source == CAN:
        return raw_steering * CAN_DEGREES_TO_STEERING_UNITS
    if steering_source == IMU:
        return (raw_steering / (velocities + 1.0)) * INVERSE_RADIUS_METERS_TO_STEERING_UNITS
    raise ValueError(f"unknown steering source {steering_source}")


def frame_to_model_input(raw_frame, crop, target_height, target_width, to_grayscale, to_yuv):
    """Crop, INTER_AREA resize, then gray (the JAX CLI's numpy weights,
    truncated) or YUV. Returns (CHW, HWC) uint8."""
    from pilotguru_tpu_torch.video.imgproc import resize_area, rgb_to_yuv

    if to_grayscale and to_yuv:
        raise ValueError("grayscale and yuv outputs are mutually exclusive")
    top, bottom, left, right = crop
    h, w = raw_frame.shape[:2]
    img = raw_frame[top : h - bottom if bottom else h, left : w - right if right else w]
    if target_height > 0 and target_width > 0 and img.shape[:2] != (target_height,
                                                                     target_width):
        img = resize_area(img, (target_width, target_height))
    if to_grayscale:
        img = np.sum(img.astype(np.float64) * GRAY_WEIGHTS, axis=2,
                     keepdims=True).astype(np.uint8)
    if to_yuv:
        img = rgb_to_yuv(img)
    return np.transpose(img, (2, 0, 1)), img


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--in_frames_json", required=True)
    parser.add_argument("--in_steering_json", required=True)
    parser.add_argument("--steering_source", default=CAN, choices=[CAN, IMU])
    parser.add_argument("--in_velocities_json", required=True)
    parser.add_argument("--in_forward_axis_json", required=True)
    parser.add_argument("--in_recording_id_json", default=None)
    parser.add_argument("--recording_id_one_hot_dims", type=int, default=100)
    parser.add_argument("--crop_settings_json", required=True)
    parser.add_argument("--min_forward_velocity_m_s", type=float, default=0.0)
    parser.add_argument("--binary_dir", default="",
                        help="Accepted for compatibility; annotation runs in-process.")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--frames_step", type=int, default=10)
    parser.add_argument("--frames_history_length", type=int, default=1)
    parser.add_argument("--frames_history_step", type=int, default=1)
    parser.add_argument("--label_lookahead_frames", default="0")
    parser.add_argument("--exclude_frames_json", default="")
    parser.add_argument("--convert_to_grayscale", type=bool, default=False)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--target_height", type=int, default=-1)
    parser.add_argument("--target_width", type=int, default=-1)
    parser.add_argument("--save_png_every", type=int, default=100)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, dtype = setup_device(args.dtype)

    from pilotguru_tpu_torch.formats import json_io, keys
    from pilotguru_tpu_torch.timeseries.interval_average import annotate_frames_values
    from pilotguru_tpu_torch.timeseries.smoothing import smooth_time_series
    from pilotguru_tpu_torch.video.io import read_video_rgb
    from pilotguru_tpu_torch.video.png import write_png

    os.makedirs(args.out_dir, exist_ok=True)
    forward_axis = np.asarray(json_io.read_forward_axis(args.in_forward_axis_json), np.float32)
    recording_onehot = None
    if args.in_recording_id_json:
        rid = json_io.read_json(args.in_recording_id_json)["recording_id"]
        if rid >= args.recording_id_one_hot_dims:
            raise ValueError("recording_id exceeds one-hot dims")
        recording_onehot = np.zeros(args.recording_id_one_hot_dims, np.float32)
        recording_onehot[rid] = 1.0

    crop_json = json_io.read_json(args.crop_settings_json)["crop_settings"]
    crop = tuple(crop_json.get(k, 0)
                 for k in ("crop_top", "crop_bottom", "crop_left", "crop_right"))

    # In-process per-frame annotation (the reference's annotate_frames
    # subprocess calls, make_steering_dataset.py:164-177, 288-296).
    frame_ids, frame_times = json_io.read_frames(args.in_frames_json)

    def annotate(in_json, root, value_name, sigma):
        times, values = json_io.read_timestamped_values(in_json, root, value_name)
        if sigma > 0:
            t_sec = (times - times[0]).astype(np.float64) * 1e-6
            values = smooth_time_series(values, t_sec, t_sec, sigma, dtype=dtype,
                                        device=device).cpu().numpy()
        vals, valid = annotate_frames_values(times, values, frame_times, dtype=dtype,
                                             device=device)
        vals, valid = vals.cpu().numpy(), valid.cpu().numpy()
        return [{"frame_id": int(frame_ids[i + 1]), value_name: float(vals[i])}
                for i in range(len(vals)) if valid[i]]

    value_key = STEERING_VALUE_BY_SOURCE[args.steering_source]
    steering_events = annotate(args.in_steering_json, keys.STEERING, value_key,
                               SMOOTHING_BY_SOURCE[args.steering_source])
    velocity_events = annotate(args.in_velocities_json, keys.VELOCITIES, keys.SPEED_M_S, -1.0)
    frames_data = join_frame_data(steering_events, velocity_events, args.steering_source)

    lookaheads = sorted(int(x) for x in args.label_lookahead_frames.split(","))
    if min(lookaheads) < 0:
        raise ValueError("negative lookaheads are not supported")
    max_lookahead = max(lookaheads)

    exclude = set()
    if args.exclude_frames_json:
        for rng in json_io.read_json(args.exclude_frames_json)["exclude"]:
            exclude.update(range(rng[0], rng[1] + 1))

    channels = 1 if args.convert_to_grayscale else 3
    history_size = ((args.frames_history_length - 1) * args.frames_history_step
                    + 1 + max_lookahead)
    frames_hist = np.zeros((history_size, channels, args.target_height, args.target_width),
                           np.uint8)
    steer_hist = np.zeros((history_size, 1), np.float32)
    vel_hist = np.zeros((history_size, 1), np.float32)
    unfilled = history_size

    video = read_video_rgb(args.in_video)
    video_idx, video_frame = -1, None

    def out_name(frame_id, data_id):
        return os.path.join(args.out_dir, f"frame-{frame_id:06d}-{data_id}")

    prev_saved = None
    prev_seen = None
    written = 0
    for frame_id, steer_value, speed in frames_data:
        if (steer_value is None or speed is None or speed < args.min_forward_velocity_m_s
                or frame_id in exclude):
            unfilled = history_size
            continue
        if prev_seen is not None and frame_id != prev_seen + 1:
            unfilled = history_size
        prev_seen = frame_id

        while video_idx < frame_id:
            video_idx, video_frame = next(video)
        frame_chw, frame_hwc = frame_to_model_input(
            video_frame, crop, args.target_height, args.target_width,
            args.convert_to_grayscale, args.convert_to_yuv)
        hist_idx = frame_id % history_size
        frames_hist[hist_idx] = frame_chw
        steer_hist[hist_idx, 0] = steer_value
        vel_hist[hist_idx, 0] = speed
        unfilled = max(0, unfilled - 1)
        if unfilled > 0:
            continue
        if prev_saved is not None and (frame_id - prev_saved) < args.frames_step:
            continue
        prev_saved = frame_id

        write_indices = [
            (hist_idx - max_lookahead - x * args.frames_history_step) % history_size
            for x in range(args.frames_history_length)
        ][::-1]
        out_frame_id = frame_id - max_lookahead

        def lookahead_labels(hist):
            return np.stack([[hist[(w + la) % history_size, 0] for la in lookaheads]
                             for w in write_indices])

        labels = steering_labels(lookahead_labels(steer_hist), lookahead_labels(vel_hist),
                                 args.steering_source)
        frame_img = frames_hist[write_indices]
        if args.frames_history_length == 1:
            frame_img = frame_img[0]
            labels = labels[0]

        if written % args.save_png_every == 0:
            # The current frame as cv2.imwrite stores it: RGB (or gray).
            write_png(out_name(out_frame_id, "img") + ".png", np.squeeze(frame_hwc))

        out_data = {"frame_img": frame_img, "steering": labels.astype(np.float32),
                    "forward_axis": forward_axis}
        if recording_onehot is not None:
            out_data["recording_id"] = recording_onehot
        np.savez_compressed(out_name(out_frame_id, "data"), **out_data)
        written += 1

    print(f"Total samples written: {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
