"""render_input_pixel_importance CLI: saliency-overlay video (port of
pilotguru_tpu.cli.render_input_pixel_importance, the reference's
python/render_input_pixel_importance.py).

Batches of frames (crop, INTER_AREA resize and YUV from video/imgproc.py)
run through the ensemble in eval mode on the device; the gradient of the
sum of the ensemble-mean prediction with respect to the input
(``saliency``, torch.autograd where the JAX CLI takes one jitted
jax.grad) is reduced by its largest magnitude over channels, upsampled to
the crop size with cv2's INTER_LINEAR on the host and blended into the
green channel. The gradient is taken in float32 unless the settings JSON
names a "compute_dtype". Writing the video and the upsampling need cv2:
the CLI does not run where cv2 is missing. The device comes from
PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda); --cuda_device_id and
--dtype are accepted and unused.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device
from pilotguru_tpu_torch.cli.predict_video import add_crop_args, load_predictor


def saliency(nets, images: torch.Tensor, forward_axis: torch.Tensor) -> torch.Tensor:
    """|d sum(mean over ``nets`` of the prediction) / d images|, its largest
    over channels: [B, H, W] for ``images`` [B, H, W, C] (float32, the nets'
    device) and ``forward_axis`` [3]. The nets stay in eval mode."""
    from pilotguru_tpu_torch.ml import models

    images = images.detach().requires_grad_(True)
    axis = forward_axis.to(images).expand(images.shape[0], 3)
    with torch.enable_grad():
        outs = torch.stack([net({models.FRAME_IMG: images, models.FORWARD_AXIS: axis}).float()
                            for net in nets])
        (grad,) = torch.autograd.grad(outs.mean(dim=0).sum(), images)
    return grad.abs().amax(dim=-1)


def overlay(crop_frame: np.ndarray, grads: np.ndarray, saturation: float) -> np.ndarray:
    """``grads`` [h, w] upsampled to the crop with cv2's INTER_LINEAR,
    scaled so that ``saturation`` is full green, and blended into the crop's
    green channel by a maximum. Needs cv2."""
    import cv2

    up = cv2.resize(grads, (crop_frame.shape[1], crop_frame.shape[0]),
                    interpolation=cv2.INTER_LINEAR)
    level = np.clip(up / saturation * 255.0, 0, 255).astype(np.uint8)
    out = crop_frame.copy()
    out[:, :, 1] = np.maximum(out[:, :, 1], level)
    return out


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--out_video", required=True)
    parser.add_argument("--forward_axis_json", required=True)
    parser.add_argument("--net_settings_json", required=True)
    parser.add_argument("--in_model_weights", required=True)
    parser.add_argument("--convert_to_yuv", type=bool, default=False)
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--frames_to_skip", type=int, default=0)
    parser.add_argument("--max_out_frames", type=int, default=-1)
    parser.add_argument("--saturation_gradient_magnitude", type=float, default=0.5)
    add_crop_args(parser)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, _ = setup_device(args.dtype)

    from pilotguru_tpu_torch.formats import json_io
    from pilotguru_tpu_torch.ml import models
    from pilotguru_tpu_torch.video.imgproc import resize_area, rgb_to_yuv
    from pilotguru_tpu_torch.video.io import VideoWriterRgb, read_video_rgb, require_cv2

    require_cv2("render_input_pixel_importance")
    net_settings = json_io.read_json(args.net_settings_json)
    net_settings.setdefault(models.COMPUTE_DTYPE, "float32")
    forward_axis = torch.as_tensor(
        json_io.read_forward_axis(args.forward_axis_json).astype(np.float32), device=device)
    th = net_settings.get("target_height")
    tw = net_settings.get("target_width")

    predictor = None
    crop_batch, model_batch = [], []
    rendered = 0
    with VideoWriterRgb(args.out_video) as sink:

        def flush():
            nonlocal rendered
            if not model_batch:
                return
            images = torch.from_numpy(np.stack(model_batch)).to(device)
            grads = saliency(predictor.nets, images, forward_axis).cpu().numpy()
            for crop_frame, g in zip(crop_batch, grads):
                sink.consume(overlay(crop_frame, g, args.saturation_gradient_magnitude))
                rendered += 1
            crop_batch.clear()
            model_batch.clear()

        for frame_idx, frame in read_video_rgb(args.in_video):
            if frame_idx < args.frames_to_skip:
                continue
            if 0 < args.max_out_frames <= rendered:
                break
            h, w = frame.shape[:2]
            cropped = frame[
                args.crop_top : h - args.crop_bottom if args.crop_bottom else h,
                args.crop_left : w - args.crop_right if args.crop_right else w,
            ]
            resized = (resize_area(cropped, (tw, th))
                       if th and tw and cropped.shape[:2] != (th, tw) else cropped)
            if args.convert_to_yuv:
                resized = rgb_to_yuv(resized)
            if predictor is None:  # the nets' input widths come from the first frame
                predictor = load_predictor(net_settings, args.in_model_weights.split(","),
                                           resized.shape, device)
            crop_batch.append(cropped)
            model_batch.append(resized.astype(np.float32) / 255.0)
            if len(model_batch) == args.batch_size:
                flush()
        flush()
    print(f"Total rendered frames: {rendered}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
