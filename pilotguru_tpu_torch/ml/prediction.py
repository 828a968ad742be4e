"""Ensemble inference helpers: load checkpoints, evaluate, the EMA trajectory
update (port of pilotguru_tpu/ml/prediction.py, itself the reference's
python/prediction_helpers.py).

The ensemble is N nets in eval mode on one explicit device, run one after
another; the prediction is their mean, as the JAX package's vmapped pass.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from pilotguru_tpu_torch.ml import convert, training
from pilotguru_tpu_torch.video.imgproc import resize_area, rgb_to_yuv


def update_future_trajectory_prediction(
    previous: Optional[np.ndarray], current: np.ndarray, lr: float
) -> np.ndarray:
    """EMA-with-shift trajectory update (prediction_helpers.py:15-29).

    Predictions are [1, T] future trajectories; each step blends the new
    prediction with the previous one shifted forward by one step."""
    if not (0 < lr <= 1):
        raise ValueError("lr must be in (0, 1]")
    current = np.asarray(current)
    if previous is None:
        return np.copy(current)
    result = np.copy(previous)
    result[0, :-1] = lr * current[0, :-1] + (1.0 - lr) * previous[0, 1:]
    result[0, -1] = current[0, -1]
    return result


class EnsemblePredictor:
    """The mean of ``nets`` (ml/models.py modules) in eval mode on
    ``device``."""

    def __init__(self, nets: List[torch.nn.Module], device="cuda"):
        self.device = torch.device(device)
        self.nets = [net.to(self.device).eval() for net in nets]

    @classmethod
    def from_checkpoints(cls, model: torch.nn.Module, checkpoint_paths: List[str],
                         device="cuda") -> "EnsemblePredictor":
        """One copy of ``model`` per checkpoint (the JAX package's msgpack
        files), each loaded with that checkpoint's weights."""
        nets = []
        for path in checkpoint_paths:
            net = copy.deepcopy(model).cpu()
            convert.load_flax_variables(net, training.load_net(path))
            nets.append(net)
        return cls(nets, device)

    @torch.no_grad()
    def __call__(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """inputs: dict of [B, ...] arrays -> ensemble-mean predictions [B, L]
        (float32)."""
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in inputs.items()}
        outs = torch.stack([net(batch).float() for net in self.nets])
        return outs.mean(dim=0).cpu().numpy()


def frame_to_model_input(
    raw_frame_hwc: np.ndarray,
    crop_top: int = 0,
    crop_bottom: int = 0,
    crop_left: int = 0,
    crop_right: int = 0,
    target_height: Optional[int] = None,
    target_width: Optional[int] = None,
    convert_to_yuv: bool = False,
):
    """Crop/resize/convert one camera frame into a [1, H, W, C] float input
    (RawFrameToModelInput, prediction_helpers.py:36-58), NHWC, with
    video/imgproc.py's INTER_AREA and YUV. Returns (model_input,
    resized_uint8_frame)."""
    h, w = raw_frame_hwc.shape[:2]
    cropped = raw_frame_hwc[
        crop_top : h - crop_bottom if crop_bottom else h,
        crop_left : w - crop_right if crop_right else w,
    ]
    if (
        target_height is not None
        and target_width is not None
        and cropped.shape[:2] != (target_height, target_width)
    ):
        cropped = resize_area(cropped, (target_width, target_height))
    if convert_to_yuv:
        cropped = rgb_to_yuv(cropped)
    model_input = cropped.astype(np.float32)[None, ...] / 255.0
    return model_input, cropped
