"""predict_video CLI: offline ensemble steering inference over a ride video.

Flag- and format-compatible with pilotguru_tpu.cli.predict_video (the
reference's python/predict_video.py): per-frame ensemble-mean prediction
with the EMA trajectory update, written as {steering: [{frame_id,
steering}]}. --net_settings_json takes the train CLI's settings dict, plus
an optional "compute_dtype" ("float32" or "bfloat16"; unset: bfloat16 on
CUDA, float32 on the CPU); --in_model_weights takes the JAX package's
msgpack checkpoints, comma-separated; --cuda_device_id is accepted and
ignored, as in the JAX CLI. --in_video may be a video file or a PNG image
list (video/io.py). The device comes from PILOTGURU_TPU_PLATFORM (cpu |
cuda, default cuda); --dtype is accepted for compatibility and unused.
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device


def add_crop_args(parser):
    parser.add_argument("--crop_top", type=int, default=0)
    parser.add_argument("--crop_bottom", type=int, default=0)
    parser.add_argument("--crop_left", type=int, default=0)
    parser.add_argument("--crop_right", type=int, default=0)


def network_from_settings(net_settings, input_shape):
    """The net that ``net_settings`` (the train CLI's settings dict) names,
    for frames of ``input_shape`` (height, width, channels)."""
    from pilotguru_tpu_torch.ml import models

    options = {
        models.NET_NAME: net_settings.get("net_name", models.NVIDIA_NET_NAME),
        models.NET_HEAD_DIMS: net_settings.get("net_head_dims", 10),
        models.LABEL_DIMENSIONS: net_settings.get("label_dimensions", 1),
        models.DROPOUT_PROB: net_settings.get("dropout_prob", 0.0),
        models.LAYER_BLOCKS_OPTIONS: net_settings.get(
            "layer_blocks_options", models.DEFAULT_LAYER_BLOCKS_OPTIONS),
    }
    if net_settings.get(models.COMPUTE_DTYPE):
        options[models.COMPUTE_DTYPE] = net_settings[models.COMPUTE_DTYPE]
    bias_options = net_settings.get(
        "linear_bias_options", [{"input_name": models.FORWARD_AXIS, "input_dims": 3}])
    return models.make_network(options, bias_options, input_shape)


def load_predictor(net_settings, model_weights_paths, input_shape, device):
    """The ensemble of ``model_weights_paths`` for frames of
    ``input_shape``, on ``device``."""
    from pilotguru_tpu_torch.ml.prediction import EnsemblePredictor

    return EnsemblePredictor.from_checkpoints(
        network_from_settings(net_settings, input_shape), model_weights_paths, device)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--forward_axis_json", required=True)
    parser.add_argument("--net_settings_json", required=True)
    parser.add_argument("--in_model_weights", required=True)
    parser.add_argument("--out_steering_json", required=True)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--trajectory_frame_update_rate", type=float, default=1.0)
    add_crop_args(parser)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, _ = setup_device(args.dtype)

    import numpy as np

    from pilotguru_tpu_torch.formats import json_io
    from pilotguru_tpu_torch.ml import models
    from pilotguru_tpu_torch.ml.prediction import (
        frame_to_model_input,
        update_future_trajectory_prediction,
    )
    from pilotguru_tpu_torch.video.io import read_video_rgb

    net_settings = json_io.read_json(args.net_settings_json)
    forward_axis = json_io.read_forward_axis(args.forward_axis_json).astype(np.float32)[None, :]

    predictor = None
    trajectory = None
    results = []
    for frame_idx, frame in read_video_rgb(args.in_video):
        model_input, _ = frame_to_model_input(
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
        results.append({"frame_id": frame_idx, "steering": float(trajectory[0, 0])})

    json_io.write_json({"steering": results}, args.out_steering_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
