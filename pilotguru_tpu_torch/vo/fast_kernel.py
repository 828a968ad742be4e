"""K1: fused FAST-9/16 response + 3x3 non-max suppression.

Port of pilotguru_tpu/vo/fast_pallas.py::fast_nms_pallas (and of the plain
``fast_scores`` + ``nms3x3`` of pilotguru_tpu/vo/features.py). ``fast_nms``
(one image) and ``fast_nms_levels`` (every level of a pyramid in one launch)
dispatch on the image's device: a CPU tensor runs ``fast_nms_plain``; a
CUDA tensor launches the hand-written kernel in csrc/fast_nms.cu or raises.
This module holds the kernel's C interface (``FastLevels``,
``SIGNATURES``) and loads its library alone.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

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

MAX_LEVELS = 8  # kMaxLevels of the level tables of csrc/fast_nms.cu and the patch gathers


class FastLevels(ctypes.Structure):
    """PgFastLevels of csrc/fast_nms.cu: the images of one launch."""

    _fields_ = [
        ("img", ctypes.c_void_p * MAX_LEVELS), ("raw", ctypes.c_void_p * MAX_LEVELS),
        ("nms", ctypes.c_void_p * MAX_LEVELS), ("h", ctypes.c_int * MAX_LEVELS),
        ("w", ctypes.c_int * MAX_LEVELS), ("count", ctypes.c_int),
    ]


# Each source's entry points: {stem: {name: (argtypes, restype)}}.
SIGNATURES = {"fast_nms": {
    # levels, threshold, stream
    "pg_fast_nms_levels": ([ctypes.POINTER(FastLevels), ctypes.c_float, ctypes.c_void_p],
                           ctypes.c_int),
}}


def library(stem: str):
    """csrc/<stem>.cu's library with its entry points bound, built on the
    first call."""
    return cuda_lib.library(stem, SIGNATURES[stem])


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
        COUNTER.count_plain_cuda_call()
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


def _check_image(name: str, image: torch.Tensor) -> None:
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            f"{name}: want a 2-D float32 image, got {image.dtype} {tuple(image.shape)}"
        )
    if not image.is_contiguous():
        raise ValueError(f"{name}: image must be contiguous")
    h, w = image.shape
    if h < 1 or w < 1 or h * w >= 2**31:
        raise ValueError(f"{name}: unsupported image size {h}x{w}")


def fast_nms(image: torch.Tensor, threshold: float = DEFAULT_THRESHOLD):
    """FAST response and its 3x3 NMS: image [H, W] float32 -> (raw, nms)."""
    if image.device.type == "cpu":
        return fast_nms_plain(image, threshold)
    return fast_nms_levels([image], threshold)[0]


def fast_nms_levels(
    images: Sequence[torch.Tensor], threshold: float = DEFAULT_THRESHOLD
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``fast_nms`` of every image of a pyramid: [(raw, nms), ...] in the
    images' order. On CUDA one launch covers all levels (at most
    ``MAX_LEVELS``), and the outputs are views of one allocation."""
    images = list(images)
    if not 1 <= len(images) <= MAX_LEVELS:
        raise ValueError(
            f"fast_nms_levels: want 1 to {MAX_LEVELS} images, got {len(images)}"
        )
    device = images[0].device
    for image in images:
        if image.device != device:
            raise ValueError(
                f"fast_nms_levels: images on different devices ({device}, {image.device})"
            )
        _check_image("fast_nms_levels", image)
    if device.type == "cpu":
        return [fast_nms_plain(image, threshold) for image in images]
    if device.type != "cuda":
        raise ValueError(f"fast_nms_levels: unsupported device {device}")
    sizes = [image.numel() for image in images]
    buffer = torch.empty((2 * sum(sizes),), dtype=torch.float32, device=device)
    table = FastLevels(count=len(images))
    out, offset = [], 0
    for level, (image, size) in enumerate(zip(images, sizes)):
        raw = buffer[offset : offset + size].view(image.shape)
        nms = buffer[offset + size : offset + 2 * size].view(image.shape)
        offset += 2 * size
        table.img[level] = image.data_ptr()
        table.raw[level] = raw.data_ptr()
        table.nms[level] = nms.data_ptr()
        table.h[level], table.w[level] = image.shape
        out.append((raw, nms))
    lib = library("fast_nms")
    # The kernel launches on the current device, which must own the stream.
    with torch.cuda.device(device):
        err = lib.pg_fast_nms_levels(
            ctypes.byref(table), ctypes.c_float(_threshold_f32(threshold)),
            cuda_lib.current_stream(device),
        )
    COUNTER.count_launch()
    cuda_lib.check_launch("fast_nms_levels", err)
    return out
