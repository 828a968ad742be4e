"""ORB-style feature extraction on tensors (port of pilotguru_tpu/vo/features.py).

Fixed-shape, like the reference: every pyramid level yields exactly its
keypoint budget (invalid slots masked). In stages: antialiased linear
resize of the level-0 image to every level; FAST-9/16 response + 3x3 NMS
of all levels in one launch (kernel K1, vo/fast_kernel.py); per level,
best-per-cell then global top-N selection and parabola sub-pixel
refinement; one Gaussian-blurred 39x39 patch per keypoint; per level,
intensity-centroid orientation and steered BRIEF from those patches. The
blurred patches come from a 17-tap blur of each whole level and one
gather over all levels in one launch (kernel K2, vo/patch_kernel.py;
``patch_impl="blur_then_gather"``, the default), or from one fused blur +
gather over all levels in one launch (kernel K3, the same module;
``patch_impl="fused"``, the reference's ``PGTPU_PATCH_IMPL=fused``).

The constant tables (FAST_CIRCLE, BRIEF_PATTERN, the BRIEF steering-bin
matrix, the orientation moment weights) are built by the reference's numpy
code; ``tables_as_tensors`` moves them to a device.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pilotguru_tpu_torch.vo.fast_kernel import (  # noqa: F401
    FAST_CIRCLE,
    MAX_LEVELS,
    fast_nms,
    fast_nms_levels,
)
from pilotguru_tpu_torch.vo.patch_kernel import (
    BLUR_SIGMA,
    PATCH_GATHER_RADIUS,
    gather_blurred_patches_levels,
    gather_patches_levels,
    gaussian_kernel,
)

PATCH_RADIUS = 15  # intensity-centroid orientation patch (ORB standard)
BRIEF_RADIUS = 13  # max |coordinate| of pattern points
DESCRIPTOR_BITS = 256
_PATCH_SIZE = 2 * PATCH_GATHER_RADIUS + 1
BRIEF_ANGLE_BINS = 32  # steering quantization (ORB paper uses 2*pi/30)
PATCH_IMPLS = ("blur_then_gather", "fused")


def make_brief_pattern(seed: int = 7) -> np.ndarray:
    """Deterministic BRIEF-II pattern: pairs ~ N(0, (patch/5)^2), clipped.

    Returns int32 [256, 4] = (y1, x1, y2, x2) in patch coordinates.
    """
    rng = np.random.default_rng(seed)
    sigma = (2 * BRIEF_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(DESCRIPTOR_BITS, 4))
    return np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)


BRIEF_PATTERN = make_brief_pattern()


def _orientation_moment_weights():
    offs = np.arange(_PATCH_SIZE, dtype=np.float32) - PATCH_GATHER_RADIUS
    dy = offs[:, None]
    dx = offs[None, :]
    circ = ((dy * dy + dx * dx) <= PATCH_RADIUS * PATCH_RADIUS).astype(
        np.float32
    )
    return dx * circ, dy * circ


_ORIENT_WX, _ORIENT_WY = _orientation_moment_weights()


def _build_brief_bin_matrix() -> np.ndarray:
    """Per-angle-bin BRIEF tap-selection matrix, int8 [S*S, BINS*256].

    Column (b, j) holds +1 at the bin-b-rotated tap-1 pixel of pair j and -1
    at tap-2 (0 where the two taps round to the same pixel), so
    patch_flat @ D = (v1 - v2) for every (bin, pair)."""
    pat = np.asarray(BRIEF_PATTERN, np.float32)
    d = np.zeros((_PATCH_SIZE * _PATCH_SIZE, BRIEF_ANGLE_BINS, pat.shape[0]),
                 np.int8)
    y1, x1, y2, x2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    for b in range(BRIEF_ANGLE_BINS):
        ang = 2 * np.pi * b / BRIEF_ANGLE_BINS
        c, s = np.cos(ang), np.sin(ang)
        for taps, sign in (((y1, x1), 1), ((y2, x2), -1)):
            ty, tx = taps
            iy = np.round(tx * s + ty * c).astype(int) + PATCH_GATHER_RADIUS
            ix = np.round(tx * c - ty * s).astype(int) + PATCH_GATHER_RADIUS
            for j in range(pat.shape[0]):
                d[iy[j] * _PATCH_SIZE + ix[j], b, j] += sign
    return d.reshape(_PATCH_SIZE * _PATCH_SIZE, -1)


_BRIEF_BIN_MATRIX = _build_brief_bin_matrix()


def _brief_taps(bin_matrix: np.ndarray):
    """The two flat patch indices each bin-matrix column reads, [BINS, 256]
    each: the +1 row and the -1 row. A column whose taps coincide is all
    zero; both indices then name the same pixel, whose difference is 0 —
    the column's value. So q[tap1] - q[tap2] == q @ column, exactly."""
    cols = bin_matrix.astype(np.int32)
    plus = np.argmax(cols, axis=0)
    minus = np.argmin(cols, axis=0)
    zero = ~cols.any(axis=0)
    minus = np.where(zero, plus, minus)
    return (
        plus.reshape(BRIEF_ANGLE_BINS, DESCRIPTOR_BITS),
        minus.reshape(BRIEF_ANGLE_BINS, DESCRIPTOR_BITS),
    )


_BRIEF_TAP1, _BRIEF_TAP2 = _brief_taps(_BRIEF_BIN_MATRIX)


class ExtractorTables(NamedTuple):
    orient_wx: torch.Tensor  # [S*S] float32
    orient_wy: torch.Tensor  # [S*S] float32
    brief_tap1: torch.Tensor  # [BINS, 256] int64
    brief_tap2: torch.Tensor  # [BINS, 256] int64


@functools.lru_cache(maxsize=8)
def tables_as_tensors(device) -> ExtractorTables:
    """The extractor's constant tables on ``device`` (read-only)."""
    device = torch.device(device)
    return ExtractorTables(
        torch.from_numpy(_ORIENT_WX.reshape(-1)).to(device),
        torch.from_numpy(_ORIENT_WY.reshape(-1)).to(device),
        torch.from_numpy(_BRIEF_TAP1.astype(np.int64)).to(device),
        torch.from_numpy(_BRIEF_TAP2.astype(np.int64)).to(device),
    )


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one image."""

    xy: torch.Tensor  # [K, 2] float32 — (x, y) in full-resolution coordinates
    response: torch.Tensor  # [K]
    angle: torch.Tensor  # [K] radians
    level: torch.Tensor  # [K] int32 pyramid level
    valid: torch.Tensor  # [K] bool
    descriptors: torch.Tensor  # [K, 256] uint8 bits (0/1)


def select_grid_topk(scores: torch.Tensor, num_keypoints: int, cell: int = 16):
    """Spatially-spread top-N selection: best-per-cell, then global top-N.

    Ties resolve as in the reference: the first maximum within a cell
    (``argmax``), and lower cell indices first among equal cell scores
    (``lax.top_k``; here a stable descending sort).
    Returns (yx [N, 2] int32, response [N], valid [N]).
    """
    h, w = scores.shape
    gh, gw = h // cell, w // cell
    flat = (
        scores[: gh * cell, : gw * cell]
        .reshape(gh, cell, gw, cell)
        .permute(0, 2, 1, 3)
        .reshape(gh * gw, cell * cell)
    )
    best = torch.argmax(flat, dim=1)
    best_score = torch.gather(flat, 1, best[:, None])[:, 0]
    cells = torch.arange(gh * gw, device=scores.device)
    y = (cells // gw) * cell + best // cell
    x = (cells % gw) * cell + best % cell

    k = min(num_keypoints, gh * gw)
    order_scores, order = torch.sort(best_score, descending=True, stable=True)
    top_scores, top_idx = order_scores[:k], order[:k]
    yx = torch.stack([y[top_idx], x[top_idx]], dim=1).to(torch.int32)
    valid = top_scores > 0
    if k < num_keypoints:
        pad = num_keypoints - k
        dev = scores.device
        yx = torch.cat([yx, torch.zeros((pad, 2), dtype=torch.int32, device=dev)])
        top_scores = torch.cat(
            [top_scores, torch.zeros((pad,), dtype=scores.dtype, device=dev)]
        )
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return yx, top_scores, valid


def subpixel_offsets(raw_scores: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Parabola sub-pixel refinement on the raw (pre-NMS) FAST responses of
    the 3-neighborhood, offsets clipped to [-0.5, 0.5]. Returns [K, 2]
    (row, col) offsets."""
    h, w = raw_scores.shape
    y = yx[:, 0].long().clamp(1, h - 2)
    x = yx[:, 1].long().clamp(1, w - 2)

    def axis_offset(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        off = torch.where(
            denom.abs() > 1e-9, 0.5 * (sm - sp) / denom, torch.zeros_like(denom)
        )
        return off.clamp(-0.5, 0.5)

    oy = axis_offset(raw_scores[y - 1, x], raw_scores[y, x], raw_scores[y + 1, x])
    ox = axis_offset(raw_scores[y, x - 1], raw_scores[y, x], raw_scores[y, x + 1])
    return torch.stack([oy, ox], dim=1)


def orientations_from_patches(patches: torch.Tensor, tables: ExtractorTables):
    """Intensity-centroid angles from [K, S, S] patches: two masked-moment
    contractions, then atan2."""
    flat = patches.reshape(patches.shape[0], -1)
    m10 = flat @ tables.orient_wx
    m01 = flat @ tables.orient_wy
    return torch.atan2(m01, m10)


def brief_from_patches(patches: torch.Tensor, angles: torch.Tensor,
                       tables: ExtractorTables) -> torch.Tensor:
    """Steered BRIEF bits from [K, S, S] patches in [0, 1] and [K] angles.

    The reference quantizes each patch to the 0..255 grid and takes
    patch_flat @ D (the steering-bin matrix) for the keypoint's bin; each
    column of D reads exactly two pixels, so that product is the difference
    q[tap1] - q[tap2], gathered here directly (exact, no matmul)."""
    k = patches.shape[0]
    q = torch.round(patches * 255.0).clamp(0.0, 255.0).reshape(k, -1)
    step = torch.full_like(angles, 2 * math.pi / BRIEF_ANGLE_BINS)
    bins = torch.remainder(torch.round(angles / step).to(torch.int64),
                           BRIEF_ANGLE_BINS)
    v1 = torch.gather(q, 1, tables.brief_tap1[bins])
    v2 = torch.gather(q, 1, tables.brief_tap2[bins])
    return (v1 < v2).to(torch.uint8)


def pyramid_level_budgets(total: int, num_levels: int, scale: float) -> List[int]:
    """Per-level keypoint budgets with the ORB 1/scale geometric split."""
    factor = 1.0 / scale
    first = total * (1 - factor) / (1 - factor**num_levels)
    budgets = [int(round(first * factor**i)) for i in range(num_levels)]
    budgets[-1] = max(total - sum(budgets[:-1]), 0)
    return budgets


def level_shapes(h: int, w: int, num_levels: int, scale: float):
    return [
        (max(int(round(h / scale**lv)), 32), max(int(round(w / scale**lv)), 32))
        for lv in range(num_levels)
    ]


def _linear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of ``jax.image.resize(method="linear")`` along one
    axis (jax's compute_weight_mat with the triangle kernel, antialiased
    when downsampling), computed in float64."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None])
    x = x / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).T


@functools.lru_cache(maxsize=64)
def _resize_taps(in_size: int, out_size: int, device):
    """Banded form of the [out, in] weights: for each output index the
    contiguous run of inputs with a non-zero weight, as (index [out, T]
    int64, weight [out, T] float32) padded with zero weights."""
    w = _linear_resize_weights(in_size, out_size)
    nz = w != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), in_size - 1 - nz[:, ::-1].argmax(1), 0)
    taps = int((last - first).max()) + 1
    idx = first[:, None] + np.arange(taps)[None, :]
    inside = idx <= last[:, None]
    idx = np.minimum(idx, in_size - 1)
    weight = np.where(inside, np.take_along_axis(w, idx, axis=1), 0.0)
    return (
        torch.from_numpy(idx).to(device),
        torch.from_numpy(weight.astype(np.float32)).to(device),
    )


def _resize_rows(image: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize along dim 0: out[o] = sum_t weight[o, t] * image[index[o, t]],
    accumulated tap by tap (multiply, then add) so every device gives the
    same float32 result."""
    idx, weight = _resize_taps(image.shape[0], out_size, image.device)
    terms = image[idx] * weight[:, :, None]  # [out, T, W]
    acc = terms[:, 0]
    for t in range(1, terms.shape[1]):
        acc = acc + terms[:, t]
    return acc


def resize_linear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased linear resize of a [H, W] float32 image with
    jax.image.resize(method="linear")'s per-axis weights, rows then
    columns."""
    rows = _resize_rows(image, out_h)
    return _resize_rows(rows.T.contiguous(), out_w).T.contiguous()


def gaussian_blur(image: torch.Tensor, sigma: float = BLUR_SIGMA) -> torch.Tensor:
    """Separable reflect-padded Gaussian blur of a [H, W] image, rows then
    columns. Taps accumulate sequentially (multiply, then add), so CPU and
    CUDA give the same float32 result."""
    taps, radius = gaussian_kernel(sigma)

    def blur_rows(x):  # along dim 0
        n = x.shape[0]
        p = F.pad(x[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
        acc = float(taps[0]) * p[0:n]
        for t in range(1, taps.shape[0]):
            acc = acc + float(taps[t]) * p[t : t + n]
        return acc

    return blur_rows(blur_rows(image).T.contiguous()).T.contiguous()


def extract_orb_features(
    image: torch.Tensor,
    num_levels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0 / 255.0,
    total_budget: int = 2000,
    cell: int = 16,
    patch_impl: str = "blur_then_gather",
) -> Keypoints:
    """Full extractor over an image pyramid -> fixed-size Keypoints.

    image: [H, W] float32 grayscale in [0, 1] on any device; the outputs
    live on the same device. Coordinates are level-0 pixels. ``patch_impl``
    picks how the blurred patches are made (PATCH_IMPLS, module docstring)."""
    if image.dtype != torch.float32 or image.dim() != 2:
        raise ValueError(
            f"extract_orb_features: want [H, W] float32, got {image.dtype} "
            f"{tuple(image.shape)}"
        )
    if patch_impl not in PATCH_IMPLS:
        raise ValueError(
            f"extract_orb_features: patch_impl {patch_impl!r} is not one of {PATCH_IMPLS}"
        )
    image = image.contiguous()
    device = image.device
    tables = tables_as_tensors(device)
    budgets = pyramid_level_budgets(total_budget, num_levels, scale)
    h, w = image.shape
    shapes = level_shapes(h, w, num_levels, scale)
    level_imgs = [image] + [resize_linear(image, lh, lw) for lh, lw in shapes[1:]]
    # One launch of K1 (and of K2 or K3 below) takes MAX_LEVELS levels; a deeper
    # pyramid goes in several.
    chunks = [slice(i, i + MAX_LEVELS) for i in range(0, num_levels, MAX_LEVELS)]
    responses = [
        pair for chunk in chunks for pair in fast_nms_levels(level_imgs[chunk], threshold)
    ]
    selected = [
        select_grid_topk(scores, budgets[level], cell)
        for level, (_, scores) in enumerate(responses)
    ]
    yx_per_level = [yx for yx, _, _ in selected]
    # One blurred patch per keypoint feeds both the orientation moments and
    # BRIEF, as in the reference. The default path blurs every level first
    # (plain PyTorch, as the reference blurs outside any Pallas kernel).
    if patch_impl == "fused":
        sources, gather = level_imgs, gather_blurred_patches_levels
    else:
        sources, gather = [gaussian_blur(img) for img in level_imgs], gather_patches_levels
    patches_per_level = [
        patches for chunk in chunks
        for patches in gather(sources[chunk], yx_per_level[chunk])
    ]
    parts = {name: [] for name in Keypoints._fields}
    for level, ((yx, resp, valid), patches) in enumerate(zip(selected, patches_per_level)):
        offsets = subpixel_offsets(responses[level][0], yx)
        # Orientation and BRIEF stay per level: a moment product of another
        # height may sum in another order than the CPU's.
        angle = orientations_from_patches(patches, tables)
        desc = brief_from_patches(patches, angle, tables)
        refined = yx.to(torch.float32) + offsets
        parts["xy"].append(
            torch.stack([refined[:, 1], refined[:, 0]], dim=1) * (scale**level)
        )
        parts["response"].append(resp)
        parts["angle"].append(angle)
        parts["level"].append(
            torch.full((yx.shape[0],), level, dtype=torch.int32, device=device)
        )
        parts["valid"].append(valid)
        parts["descriptors"].append(desc)
    return Keypoints(**{name: torch.cat(v) for name, v in parts.items()})


def extract_orb_features_batch(
    images: torch.Tensor,
    num_levels: int = 8,
    scale: float = 1.2,
    threshold: float = 20.0 / 255.0,
    total_budget: int = 2000,
    cell: int = 16,
    patch_impl: str = "blur_then_gather",
) -> Keypoints:
    """``extract_orb_features`` of each image of a batch: [B, H, W] float32
    -> Keypoints with a leading batch dimension. The frames run one after
    the other, as the reference's ``lax.map``, so each launches K1 and K2
    (or K3) once, exactly as a frame extracted alone."""
    if images.dim() != 3:
        raise ValueError(
            f"extract_orb_features_batch: want [B, H, W], got {tuple(images.shape)}"
        )
    frames = [
        extract_orb_features(image, num_levels=num_levels, scale=scale, threshold=threshold,
                             total_budget=total_budget, cell=cell, patch_impl=patch_impl)
        for image in images
    ]
    return Keypoints(*(torch.stack(field) for field in zip(*frames)))
