"""K2: per-keypoint square patch gather.

Port of pilotguru_tpu/vo/patch_pallas.py::gather_patches_pallas (and of the
plain ``extract_patches`` of pilotguru_tpu/vo/features.py). ``gather_patches``
dispatches on the image's device: a CPU tensor runs ``gather_patches_plain``;
a CUDA tensor launches the hand-written kernel in csrc/patch_gather.cu or
raises.
"""

from __future__ import annotations

import torch

from pilotguru_tpu_torch import cuda_lib

PATCH_GATHER_RADIUS = 19  # covers orientation (r=15) + rotated BRIEF taps

COUNTER = cuda_lib.KernelCounter("gather_patches")


def gather_patches_plain(
    image: torch.Tensor, yx: torch.Tensor, radius: int = PATCH_GATHER_RADIUS
):
    """Plain PyTorch version of K2: [K, 2r+1, 2r+1] patches.

    patch k = edge_pad(image, r)[y:y+2r+1, x:x+2r+1] with (y, x) = yx[k]
    clamped into the image, the start clamping of ``dynamic_slice``."""
    if image.is_cuda:
        COUNTER.plain_cuda_calls += 1
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
    if image.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {image.device}")
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            "gather_patches: want a 2-D float32 image, got "
            f"{image.dtype} {tuple(image.shape)}"
        )
    if yx.device != image.device or yx.dtype != torch.int32 or yx.dim() != 2 \
            or yx.shape[1] != 2:
        raise ValueError(
            "gather_patches: want yx as [K, 2] int32 on the image's device, got "
            f"{yx.dtype} {tuple(yx.shape)} on {yx.device}"
        )
    if not (image.is_contiguous() and yx.is_contiguous()):
        raise ValueError("gather_patches: image and yx must be contiguous")
    if radius < 0:
        raise ValueError(f"gather_patches: radius must be >= 0, got {radius}")
    h, w = image.shape
    k = yx.shape[0]
    size = 2 * radius + 1
    out = torch.empty((k, size, size), dtype=image.dtype, device=image.device)
    if k == 0:
        return out
    lib = cuda_lib.library()
    err = lib.pg_gather_patches(
        image.data_ptr(), yx.data_ptr(), out.data_ptr(), h, w, k, radius,
        cuda_lib.current_stream(image.device),
    )
    COUNTER.launches += 1
    cuda_lib.check_launch("gather_patches", err)
    return out
