"""Batch augmentation for steering training, on the device (port of
pilotguru_tpu/ml/augmentation.py, itself the reference's
python/augmentation.py and python/image_helpers.py:161-224).

The chain, applied inside the train step to a whole batch:

  1. horizontal shifted crop with linear label adjustment: fraction
     ~ U(-1, 1), shift = round(fraction * max_shift) (half to even, as
     ``jnp.round``), crop [margin + shift, margin + shift + target_width),
     label += fraction * shift_rate;
  2. PCA RGB shift: per-direction N(0, 1) magnitudes, one colour offset over
     each image;
  3. Gaussian blur with a per-example probability: separable, reflect
     padding (numpy's "reflect", as ``jnp.pad``), radius round(4 sigma);
  4. grayscale with a per-example probability, ITU-R 601 weights.

The random draws are split from their application: ``draw_augmentation``
takes them from an explicit ``torch.Generator``, and ``augment_batch``
applies given draws, so the same draws (the JAX package's own, in the
tests) give the same images. As in the JAX package, the pixel augmenters
run after the crop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

RGB_TO_GRAY = (0.2989, 0.5870, 0.1140)


@dataclass(frozen=True)
class AugmentSettings:
    """Mirrors augmentation.AugmentSettings (augmentation.py:81-94)."""

    target_width: int = -1
    max_horizontal_shift_pixels: int = 0
    horizontal_label_shift_rate: Tuple[float, ...] = (0.0,)
    blur_sigma: float = 2.0
    blur_prob: float = 0.0
    grayscale_interpolate_prob: float = 0.0
    random_shift_directions: Optional[np.ndarray] = None  # [D, C]


class AugmentDraws(NamedTuple):
    """One batch's random draws; a field is None where its augmenter is
    off."""

    shift_fraction: Optional[torch.Tensor]  # [B] ~ U(-1, 1)
    pca_magnitudes: Optional[torch.Tensor]  # [B, D] ~ N(0, 1)
    blur: Optional[torch.Tensor]  # [B] bool, Bernoulli(blur_prob)
    grayscale: Optional[torch.Tensor]  # [B] bool, Bernoulli(grayscale_interpolate_prob)


def draw_augmentation(generator: torch.Generator, batch: int, settings: AugmentSettings,
                      device, dtype=torch.float32) -> AugmentDraws:
    """The draws ``augment_batch`` needs for ``batch`` examples under
    ``settings``, from ``generator`` (on ``device``)."""

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)

    fraction = mags = blur = gray = None
    if settings.max_horizontal_shift_pixels > 0:
        fraction = uniform(batch) * 2.0 - 1.0
    if settings.random_shift_directions is not None:
        d = np.asarray(settings.random_shift_directions).shape[0]
        mags = torch.randn((batch, d), generator=generator, device=device, dtype=dtype)
    if settings.blur_prob > 0:
        blur = uniform(batch) < settings.blur_prob
    if settings.grayscale_interpolate_prob > 0:
        gray = uniform(batch) < settings.grayscale_interpolate_prob
    return AugmentDraws(fraction, mags, blur, gray)


def center_crop_width(images: torch.Tensor, target_width: int) -> torch.Tensor:
    """Centred width crop (io_helpers.py:128-133); images [..., W, C]."""
    left = (images.shape[-2] - target_width) // 2
    return images[..., left:left + target_width, :]


def random_shifted_crop(images, labels, target_width: int, max_shift: int, shift_rate,
                        fraction):
    """Per-example off-centre crops with linear label adjustment.

    images [B, H, W, C]; labels [B, L]; shift_rate [L]; fraction [B] in
    (-1, 1). A start outside the image is clamped into it, as
    ``jax.lax.dynamic_slice`` does."""
    b, h, w, _ = images.shape
    margin = (w - target_width) // 2
    shift = torch.round(fraction * max_shift).to(torch.int64)
    left = (margin + shift).clamp(0, w - target_width)
    cols = left[:, None] + torch.arange(target_width, device=images.device)  # [B, T]
    rows = torch.arange(b, device=images.device)[:, None]
    cropped = images.permute(0, 2, 1, 3)[rows, cols].permute(0, 2, 1, 3)
    rate = torch.as_tensor(shift_rate, dtype=labels.dtype, device=labels.device)
    return cropped, labels + fraction[:, None].to(labels.dtype) * rate[None, :]


def pca_rgb_directions(images: np.ndarray) -> np.ndarray:
    """Variance-scaled PCA directions of pixel colours
    (image_helpers.py:161-168), numpy on the host. images: [..., C] floats
    in [0, 1]. Returns [C, C], rows explained_variance * component."""
    flat = np.reshape(images, (-1, images.shape[-1])).astype(np.float64)
    centered = flat - flat.mean(axis=0)
    cov = centered.T @ centered / flat.shape[0]
    eigvals, eigvecs = np.linalg.eigh(cov)
    order = np.argsort(eigvals)[::-1]
    return (eigvals[order][:, None] * eigvecs[:, order].T).astype(np.float32)


def random_pca_shift(images, directions, magnitudes):
    """One colour offset per example along the data's PCA directions:
    images [B, H, W, C], directions [D, C], magnitudes [B, D]."""
    directions = torch.as_tensor(np.asarray(directions), dtype=images.dtype,
                                 device=images.device)
    shift = magnitudes.to(images.dtype) @ directions  # [B, C]
    return images + shift[:, None, None, :]


def gaussian_kernel(sigma: float) -> Tuple[np.ndarray, int]:
    """The normalised 1-D Gaussian taps (float64) and their radius,
    max(round(4 sigma), 1)."""
    radius = max(int(round(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum(), radius


def gaussian_blur(images: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable reflect-padded Gaussian blur of [B, H, W, C] images: down
    the rows, then along them."""
    taps, radius = gaussian_kernel(sigma)
    k = torch.as_tensor(taps, dtype=images.dtype, device=images.device)
    b, h, w, c = images.shape
    x = images.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="reflect"), k.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    weights = torch.as_tensor(RGB_TO_GRAY, dtype=images.dtype, device=images.device)
    gray = torch.sum(images * weights, dim=-1, keepdim=True)
    return gray.expand(images.shape)


def _per_example(apply, transformed, original):
    return torch.where(apply[:, None, None, None], transformed, original)


def augment_batch(images, labels, settings: AugmentSettings, draws: AugmentDraws):
    """Apply the configured augmenter chain to one batch with ``draws``
    (``draw_augmentation``'s). images [B, H, W, C] floats in [0, 1];
    labels [B, L]. Returns (images [B, H, target_width, C], labels)."""
    if settings.max_horizontal_shift_pixels > 0:
        if settings.target_width <= 0:
            raise ValueError("target_width required with shift augmentation")
        images, labels = random_shifted_crop(
            images, labels, settings.target_width, settings.max_horizontal_shift_pixels,
            settings.horizontal_label_shift_rate, draws.shift_fraction)
    elif settings.target_width > 0:
        images = center_crop_width(images, settings.target_width)
    if settings.random_shift_directions is not None:
        images = random_pca_shift(images, settings.random_shift_directions,
                                  draws.pca_magnitudes)
    if settings.blur_prob > 0:
        images = _per_example(draws.blur, gaussian_blur(images, settings.blur_sigma), images)
    if settings.grayscale_interpolate_prob > 0:
        images = _per_example(draws.grayscale, grayscale(images), images)
    return images, labels
