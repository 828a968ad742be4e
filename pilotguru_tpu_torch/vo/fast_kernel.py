"""K1: fused FAST-9/16 response + 3x3 non-max suppression.

Port of pilotguru_tpu/vo/fast_pallas.py::fast_nms_pallas (and of the plain
``fast_scores`` + ``nms3x3`` of pilotguru_tpu/vo/features.py). ``fast_nms``
dispatches on the image's device: a CPU tensor runs ``fast_nms_plain``; a
CUDA tensor launches the hand-written kernel in csrc/fast_nms.cu or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pilotguru_tpu_torch import cuda_lib

# 16-pixel Bresenham circle of radius 3 (FAST-9/16), starting at 12 o'clock,
# clockwise: (row, col) offsets. csrc/fast_nms.cu holds the same table.
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

DEFAULT_THRESHOLD = 20.0 / 255.0

COUNTER = cuda_lib.KernelCounter("fast_nms")


def _threshold_f32(threshold: float) -> float:
    # The comparisons and subtractions run in float32 on both paths.
    return float(np.float32(threshold))


def _rot16(x, k: int):
    """Circular right-rotate of the low 16 bits (bit t <- bit (t+k) mod 16)."""
    return ((x >> k) | (x << (16 - k))) & 0xFFFF


def _has_arc(p):
    """>= 9 contiguous set bits on the 16-cycle: R_2k = R_k & rot(R_k, k)."""
    r2 = p & _rot16(p, 1)
    r4 = r2 & _rot16(r2, 2)
    r8 = r4 & _rot16(r4, 4)
    return (r8 & _rot16(p, 8)) != 0


def fast_nms_plain(image: torch.Tensor, threshold: float = DEFAULT_THRESHOLD):
    """Plain PyTorch version of K1. image [H, W] float32 -> (raw, nms).

    The 16 taps accumulate sequentially in FAST_CIRCLE order, as the Pallas
    body and the CUDA kernel do, so the three agree bit for bit."""
    if image.is_cuda:
        COUNTER.plain_cuda_calls += 1
    thr = _threshold_f32(threshold)
    h, w = image.shape
    padded = F.pad(image[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    bright = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    dark = torch.zeros_like(bright)
    bsum = torch.zeros_like(image)
    dsum = torch.zeros_like(image)
    zero = torch.zeros((), dtype=image.dtype, device=image.device)
    for t, (dy, dx) in enumerate(FAST_CIRCLE):
        tap = padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
        d = tap - image
        b = d > thr
        k = d < -thr
        bright = bright | (b.to(torch.int32) << t)
        dark = dark | (k.to(torch.int32) << t)
        bsum = bsum + torch.where(b, d - thr, zero)
        dsum = dsum + torch.where(k, -d - thr, zero)
    corner = _has_arc(bright) | _has_arc(dark)
    raw = torch.where(corner, torch.maximum(bsum, dsum), zero)
    interior = torch.zeros((h, w), dtype=torch.bool, device=image.device)
    interior[3 : h - 3, 3 : w - 3] = True
    raw = torch.where(interior, raw, zero)
    # 3x3 max with -inf padding (max_pool2d's), ties keep the pixel.
    nbr = F.max_pool2d(raw[None, None], 3, stride=1, padding=1)[0, 0]
    nms = torch.where(raw >= nbr, raw, zero)
    return raw, nms


def fast_nms(image: torch.Tensor, threshold: float = DEFAULT_THRESHOLD):
    """FAST response and its 3x3 NMS: image [H, W] float32 -> (raw, nms)."""
    if image.device.type == "cpu":
        return fast_nms_plain(image, threshold)
    if image.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {image.device}")
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            f"fast_nms: want a 2-D float32 image, got {image.dtype} {tuple(image.shape)}"
        )
    if not image.is_contiguous():
        raise ValueError("fast_nms: image must be contiguous")
    h, w = image.shape
    if h < 1 or w < 1 or h * w >= 2**31:
        raise ValueError(f"fast_nms: unsupported image size {h}x{w}")
    raw = torch.empty_like(image)
    nms = torch.empty_like(image)
    lib = cuda_lib.library()
    err = lib.pg_fast_nms(
        image.data_ptr(), raw.data_ptr(), nms.data_ptr(), h, w,
        ctypes.c_float(_threshold_f32(threshold)),
        cuda_lib.current_stream(image.device),
    )
    COUNTER.launches += 1
    cuda_lib.check_launch("fast_nms", err)
    return raw, nms
