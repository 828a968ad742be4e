"""K2 (per-keypoint square patch gather) and K3 (the same gather fused with
the Gaussian blur).

Ports of pilotguru_tpu/vo/patch_pallas.py::gather_patches_pallas (and of the
plain ``extract_patches`` of pilotguru_tpu/vo/features.py) and of
``gather_blurred_patches_pallas``. ``gather_patches``,
``gather_patches_levels``, ``gather_blurred_patches`` and
``gather_blurred_patches_levels`` (the ``_levels`` entries: every level of a
pyramid in one launch) dispatch on the image's device: a CPU tensor runs the
plain version; a CUDA tensor launches the hand-written kernel
(csrc/patch_gather.cu, csrc/blur_patch_gather.cu) or raises. This module
holds the kernels' C interface (``PatchLevels``, ``BlurLevels``,
``SIGNATURES``) and loads each source's library alone.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from pilotguru_tpu_torch import cuda_lib
from pilotguru_tpu_torch.vo.fast_kernel import MAX_LEVELS

PATCH_GATHER_RADIUS = 19  # covers orientation (r=15) + rotated BRIEF taps
BLUR_SIGMA = 2.0

COUNTER = cuda_lib.KernelCounter("gather_patches")
BLUR_COUNTER = cuda_lib.KernelCounter("gather_blurred_patches")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


class PatchLevels(ctypes.Structure):
    """PgPatchLevels of csrc/patch_gather.cu: the images of one launch and
    each one's keypoints."""

    _fields_ = [
        ("img", _VOIDP * MAX_LEVELS), ("yx", _VOIDP * MAX_LEVELS),
        ("h", _INT * MAX_LEVELS), ("w", _INT * MAX_LEVELS),
        ("num_keypoints", _INT * MAX_LEVELS), ("count", _INT),
    ]


class BlurLevels(ctypes.Structure):
    """PgBlurLevels of csrc/blur_patch_gather.cu: the images of one launch
    and how many of the keypoints each holds."""

    _fields_ = [
        ("img", _VOIDP * MAX_LEVELS), ("h", _INT * MAX_LEVELS),
        ("w", _INT * MAX_LEVELS), ("num_keypoints", _INT * MAX_LEVELS),
        ("count", _INT),
    ]


# Each source's entry points: {stem: {name: (argtypes, restype)}}.
SIGNATURES = {
    # levels, out, radius, stream
    "patch_gather": {"pg_gather_patches_levels": (
        [ctypes.POINTER(PatchLevels), _VOIDP, _INT, _VOIDP], _INT)},
    # levels, yx, taps (host), out, radius, blur radius, stream
    "blur_patch_gather": {"pg_blur_patch_gather_levels": (
        [ctypes.POINTER(BlurLevels), _VOIDP, ctypes.POINTER(ctypes.c_float), _VOIDP, _INT, _INT,
         _VOIDP], _INT)},
}


def library(stem: str):
    """csrc/<stem>.cu's library with its entry points bound, built on the
    first call."""
    return cuda_lib.library(stem, SIGNATURES[stem])


def gaussian_kernel(sigma: float):
    """Normalized 1-D Gaussian taps (float64 build, float32 values) and the
    radius (round(4 sigma)), as pilotguru_tpu/ml/augmentation.py."""
    radius = max(int(round(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32), radius


def _check_image_and_yx(name: str, image: torch.Tensor, yx: torch.Tensor) -> None:
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            f"{name}: want a 2-D float32 image, got {image.dtype} {tuple(image.shape)}"
        )
    if yx.device != image.device or yx.dtype != torch.int32 or yx.dim() != 2 \
            or yx.shape[1] != 2:
        raise ValueError(
            f"{name}: want yx as [K, 2] int32 on the image's device, got "
            f"{yx.dtype} {tuple(yx.shape)} on {yx.device}"
        )
    if not (image.is_contiguous() and yx.is_contiguous()):
        raise ValueError(f"{name}: image and yx must be contiguous")


def gather_patches_plain(
    image: torch.Tensor, yx: torch.Tensor, radius: int = PATCH_GATHER_RADIUS
):
    """Plain PyTorch version of K2: [K, 2r+1, 2r+1] patches.

    patch k = edge_pad(image, r)[y:y+2r+1, x:x+2r+1] with (y, x) = yx[k]
    clamped into the image, the start clamping of ``dynamic_slice``."""
    if image.is_cuda:
        COUNTER.count_plain_cuda_call()
    h, w = image.shape
    size = 2 * radius + 1
    offs = torch.arange(size, device=image.device) - radius
    ys = yx[:, 0].long().clamp(0, h - 1)
    xs = yx[:, 1].long().clamp(0, w - 1)
    rows = (ys[:, None] + offs[None, :]).clamp(0, h - 1)  # [K, S]
    cols = (xs[:, None] + offs[None, :]).clamp(0, w - 1)  # [K, S]
    return image[rows[:, :, None], cols[:, None, :]]


def gather_patches(
    image: torch.Tensor, yx: torch.Tensor, radius: int = PATCH_GATHER_RADIUS
):
    """Patch gather: image [H, W] float32, yx [K, 2] int32 -> [K, S, S]."""
    if image.device.type == "cpu":
        return gather_patches_plain(image, yx, radius)
    return gather_patches_levels([image], [yx], radius)[0]


def _check_levels(name, images, yx_per_level):
    """Validate the arguments of an all-level entry; returns the device."""
    if not 1 <= len(images) <= MAX_LEVELS or len(images) != len(yx_per_level):
        raise ValueError(
            f"{name}: want 1 to {MAX_LEVELS} images and as many keypoint sets, "
            f"got {len(images)} and {len(yx_per_level)}"
        )
    device = images[0].device
    for image, yx in zip(images, yx_per_level):
        if image.device != device:
            raise ValueError(f"{name}: images on different devices ({device}, {image.device})")
        _check_image_and_yx(name, image, yx)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def gather_patches_levels(
    images: Sequence[torch.Tensor], yx_per_level: Sequence[torch.Tensor],
    radius: int = PATCH_GATHER_RADIUS,
) -> List[torch.Tensor]:
    """``gather_patches`` of every level of a pyramid: images[l] [H_l, W_l]
    float32 and yx_per_level[l] [K_l, 2] int32 -> a list of [K_l, S, S]
    patches. On CUDA one launch covers all levels (at most
    ``MAX_LEVELS``), reading each level's keypoints where they lie,
    and the outputs are views of one allocation; the kernel is built for
    radius PATCH_GATHER_RADIUS only."""
    name = "gather_patches_levels"
    images, yx_per_level = list(images), list(yx_per_level)
    device = _check_levels(name, images, yx_per_level)
    if device.type == "cpu":
        return [gather_patches_plain(image, yx, radius)
                for image, yx in zip(images, yx_per_level)]
    if radius != PATCH_GATHER_RADIUS:
        raise ValueError(f"{name}: the kernel is built for radius {PATCH_GATHER_RADIUS}, "
                         f"got radius {radius}")
    table = PatchLevels(count=len(images))
    for level, (image, yx) in enumerate(zip(images, yx_per_level)):
        table.img[level], table.yx[level] = image.data_ptr(), yx.data_ptr()
        table.h[level], table.w[level] = image.shape
        table.num_keypoints[level] = yx.shape[0]
    counts = [yx.shape[0] for yx in yx_per_level]
    size = 2 * radius + 1
    out = torch.empty((sum(counts), size, size), dtype=torch.float32, device=device)
    if sum(counts) > 0:
        with torch.cuda.device(device):  # the launch's device owns the stream
            err = library("patch_gather").pg_gather_patches_levels(
                ctypes.byref(table), out.data_ptr(), radius, cuda_lib.current_stream(device))
        COUNTER.count_launch()
        cuda_lib.check_launch(name, err)
    return list(out.split(counts))


def _reflect_edge_index(p: torch.Tensor, n: int, radius: int, blur_radius: int):
    """Index into an axis of length ``n`` of position ``p`` on that axis
    edge-padded by ``radius`` after a reflect padding by ``blur_radius``
    (numpy's "reflect": the edge sample is not repeated)."""
    q = p.clamp(radius, radius + n + 2 * blur_radius - 1) - radius - blur_radius
    q = q.abs()
    return torch.where(q > n - 1, 2 * (n - 1) - q, q)


def gather_blurred_patches_plain(
    image: torch.Tensor, yx: torch.Tensor, radius: int = PATCH_GATHER_RADIUS,
    sigma: float = BLUR_SIGMA,
):
    """Plain PyTorch version of K3: [K, 2r+1, 2r+1] Gaussian-blurred patches.

    Contract: yx are in-image keypoints (row, col); others are clamped into
    the image first, as K2 clamps. With P = edge_pad(reflect_pad(image, br),
    r), br = round(4 sigma), patch k is the separable blur (vertical pass,
    then horizontal) of the raw window P[y : y+2r+1+2br, x : x+2r+1+2br],
    each pass summing its taps one by one (multiply, then add), as the
    Pallas body does. Within br + r pixels of the border this differs from
    blur-then-gather by construction: the blur sees the edge-padded raw
    image, not the reflect-padded one."""
    if image.is_cuda:
        BLUR_COUNTER.count_plain_cuda_call()
    taps, br = gaussian_kernel(sigma)
    h, w = image.shape
    size = 2 * radius + 1
    win = size + 2 * br
    offs = torch.arange(win, device=image.device)
    ys = yx[:, 0].long().clamp(0, h - 1)
    xs = yx[:, 1].long().clamp(0, w - 1)
    rows = _reflect_edge_index(ys[:, None] + offs[None, :], h, radius, br)  # [K, win]
    cols = _reflect_edge_index(xs[:, None] + offs[None, :], w, radius, br)
    window = image[rows[:, :, None], cols[:, None, :]]  # [K, win, win]
    vert = float(taps[0]) * window[:, 0:size, :]
    for u in range(1, taps.shape[0]):
        vert = vert + float(taps[u]) * window[:, u : u + size, :]
    out = float(taps[0]) * vert[:, :, 0:size]
    for v in range(1, taps.shape[0]):
        out = out + float(taps[v]) * vert[:, :, v : v + size]
    return out


def _check_blur_shape(name: str, image: torch.Tensor, radius: int, sigma: float):
    """K3 is compiled for the extractor's one shape: 39x39 patches (radius
    19) under the 17-tap blur (sigma 2). Returns the taps as a host array
    for the launch."""
    taps, br = gaussian_kernel(sigma)
    if radius != PATCH_GATHER_RADIUS or br != 8:
        raise ValueError(
            f"{name}: the kernel is built for radius {PATCH_GATHER_RADIUS} and a blur "
            f"radius of 8 (sigma {BLUR_SIGMA}), got radius {radius}, sigma {sigma}"
        )
    if br >= min(image.shape):
        raise ValueError(f"{name}: a {tuple(image.shape)} image is too small to reflect-pad")
    return (ctypes.c_float * taps.shape[0])(*taps.tolist()), br


def gather_blurred_patches(
    image: torch.Tensor, yx: torch.Tensor, radius: int = PATCH_GATHER_RADIUS,
    sigma: float = BLUR_SIGMA,
):
    """Fused blur + patch gather: image [H, W] float32, yx [K, 2] int32 ->
    [K, S, S] blurred patches (see gather_blurred_patches_plain)."""
    if image.device.type == "cpu":
        return gather_blurred_patches_plain(image, yx, radius, sigma)
    return gather_blurred_patches_levels([image], [yx], radius, sigma)[0]


def gather_blurred_patches_levels(
    images: Sequence[torch.Tensor], yx_per_level: Sequence[torch.Tensor],
    radius: int = PATCH_GATHER_RADIUS, sigma: float = BLUR_SIGMA,
) -> List[torch.Tensor]:
    """``gather_blurred_patches`` of every level of a pyramid: images[l]
    [H_l, W_l] float32 and yx_per_level[l] [K_l, 2] int32 -> a list of
    [K_l, S, S] patches. On CUDA one launch covers all levels (at most
    ``MAX_LEVELS``), and the outputs are views of one allocation."""
    name = "gather_blurred_patches_levels"
    images, yx_per_level = list(images), list(yx_per_level)
    device = _check_levels(name, images, yx_per_level)
    if device.type == "cpu":
        return [gather_blurred_patches_plain(image, yx, radius, sigma)
                for image, yx in zip(images, yx_per_level)]
    table = BlurLevels(count=len(images))
    for level, (image, yx) in enumerate(zip(images, yx_per_level)):
        taps, br = _check_blur_shape(name, image, radius, sigma)
        table.img[level] = image.data_ptr()
        table.h[level], table.w[level] = image.shape
        table.num_keypoints[level] = yx.shape[0]
    counts = [yx.shape[0] for yx in yx_per_level]
    size = 2 * radius + 1
    out = torch.empty((sum(counts), size, size), dtype=torch.float32, device=device)
    if sum(counts) > 0:
        all_yx = yx_per_level[0] if len(yx_per_level) == 1 else torch.cat(yx_per_level)
        lib = library("blur_patch_gather")
        with torch.cuda.device(device):  # the launch's device owns the stream
            err = lib.pg_blur_patch_gather_levels(
                ctypes.byref(table), all_yx.data_ptr(), taps, out.data_ptr(), radius, br,
                cuda_lib.current_stream(device),
            )
        BLUR_COUNTER.count_launch()
        cuda_lib.check_launch(name, err)
    return list(out.split(counts))
