"""A plain ORB extractor: the arithmetic the VO path's feature extractor
states, written in plain torch, for the benchmark's comparison.

Pyramid by an antialiased linear resize (taps summed one by one), FAST-9/16
response with a 3x3 non-maximum suppression, best-per-cell then global
top-N selection per level, parabola sub-pixel refinement, a 17-tap
reflect-padded Gaussian blur of each level, one 39x39 patch per keypoint
gathered from the blurred level, intensity-centroid orientation and steered
BRIEF read from that patch. Every step sums in a fixed order, so the same
frame gives the same bits on any device. Imports nothing of the program
under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
PATCH_GATHER_RADIUS = 19
PATCH_SIZE = 2 * PATCH_GATHER_RADIUS + 1
PATCH_RADIUS = 15
BRIEF_RADIUS = 13
DESCRIPTOR_BITS = 256
BRIEF_ANGLE_BINS = 32
BLUR_SIGMA = 2.0
CELL = 16


class Features(NamedTuple):
    yx: torch.Tensor  # [K, 2] int32 (row, col) on the keypoint's level
    xy: torch.Tensor  # [K, 2] level-0 pixels (x, y)
    angle: torch.Tensor  # [K]
    level: torch.Tensor  # [K] int32
    valid: torch.Tensor  # [K] bool
    descriptors: torch.Tensor  # [K, 256] uint8 bits


def brief_pattern(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = (2 * BRIEF_RADIUS + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(DESCRIPTOR_BITS, 4))
    return np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)


def brief_taps():
    """Flat patch indices of each pair's two taps for each steering bin,
    [BINS, 256] each; a pair whose taps round to one pixel reads it twice."""
    pat = brief_pattern().astype(np.float32)
    tap1 = np.zeros((BRIEF_ANGLE_BINS, DESCRIPTOR_BITS), np.int64)
    tap2 = np.zeros_like(tap1)
    for b in range(BRIEF_ANGLE_BINS):
        ang = 2 * np.pi * b / BRIEF_ANGLE_BINS
        c, s = np.cos(ang), np.sin(ang)
        for out, (ty, tx) in ((tap1, (pat[:, 0], pat[:, 1])), (tap2, (pat[:, 2], pat[:, 3]))):
            iy = np.round(tx * s + ty * c).astype(int) + PATCH_GATHER_RADIUS
            ix = np.round(tx * c - ty * s).astype(int) + PATCH_GATHER_RADIUS
            out[b] = iy * PATCH_SIZE + ix
    return tap1, tap2


def moment_weights():
    offs = np.arange(PATCH_SIZE, dtype=np.float32) - PATCH_GATHER_RADIUS
    dy, dx = offs[:, None], offs[None, :]
    circ = ((dy * dy + dx * dx) <= PATCH_RADIUS * PATCH_RADIUS).astype(np.float32)
    return (dx * circ).reshape(-1), (dy * circ).reshape(-1)


def level_budgets(total: int, levels: int, scale: float):
    factor = 1.0 / scale
    first = total * (1 - factor) / (1 - factor ** levels)
    budgets = [int(round(first * factor ** i)) for i in range(levels)]
    budgets[-1] = max(total - sum(budgets[:-1]), 0)
    return budgets


def level_shapes(h: int, w: int, levels: int, scale: float):
    return [(max(int(round(h / scale ** lv)), 32), max(int(round(w / scale ** lv)), 32))
            for lv in range(levels)]


def _resize_weights(in_size: int, out_size: int):
    """Banded [out, taps] (index, weight) of the antialiased triangle resize
    along one axis, weights computed in float64 and rounded to float32."""
    inv = in_size / out_size
    kscale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).T
    nz = w != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), in_size - 1 - nz[:, ::-1].argmax(1), 0)
    taps = int((last - first).max()) + 1
    idx = first[:, None] + np.arange(taps)[None, :]
    ok = idx <= last[:, None]
    idx = np.minimum(idx, in_size - 1)
    return idx, np.where(ok, np.take_along_axis(w, idx, axis=1), 0.0).astype(np.float32)


def _resize_rows(image, out_size):
    idx, weight = _resize_weights(image.shape[0], out_size)
    idx = torch.from_numpy(idx).to(image.device)
    weight = torch.from_numpy(weight).to(image.device, image.dtype)
    terms = image[idx] * weight[:, :, None]
    acc = terms[:, 0]
    for t in range(1, terms.shape[1]):
        acc = acc + terms[:, t]
    return acc


def resize(image, out_h, out_w):
    rows = _resize_rows(image, out_h)
    return _resize_rows(rows.T.contiguous(), out_w).T.contiguous()


def _rot16(x, k):
    return ((x >> k) | (x << (16 - k))) & 0xFFFF


def _has_arc(p):
    r2 = p & _rot16(p, 1)
    r4 = r2 & _rot16(r2, 2)
    r8 = r4 & _rot16(r4, 4)
    return (r8 & _rot16(p, 8)) != 0


def fast_nms(image, threshold: float):
    """FAST-9/16 response (sum of the tap differences past the threshold on
    the brighter or darker side, where 9 contiguous taps pass) and its 3x3
    non-maximum suppression: (raw, nms) [H, W] float32."""
    thr = float(torch.tensor(threshold, dtype=image.dtype))
    h, w = image.shape
    padded = F.pad(image[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    bright = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    dark = torch.zeros_like(bright)
    bsum = torch.zeros_like(image)
    dsum = torch.zeros_like(image)
    zero = torch.zeros((), dtype=image.dtype, device=image.device)
    for t, (dy, dx) in enumerate(FAST_CIRCLE):
        d = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - image
        b, k = d > thr, d < -thr
        bright = bright | (b.to(torch.int32) << t)
        dark = dark | (k.to(torch.int32) << t)
        bsum = bsum + torch.where(b, d - thr, zero)
        dsum = dsum + torch.where(k, -d - thr, zero)
    raw = torch.where(_has_arc(bright) | _has_arc(dark), torch.maximum(bsum, dsum), zero)
    interior = torch.zeros((h, w), dtype=torch.bool, device=image.device)
    interior[3:h - 3, 3:w - 3] = True
    raw = torch.where(interior, raw, zero)
    nbr = F.max_pool2d(raw[None, None], 3, stride=1, padding=1)[0, 0]
    return raw, torch.where(raw >= nbr, raw, zero)


def select(scores, count: int):
    """Best score per 16x16 cell (first maximum), then the ``count`` best
    cells (a stable descending sort); (yx [count, 2] int32, valid)."""
    h, w = scores.shape
    gh, gw = h // CELL, w // CELL
    flat = scores[:gh * CELL, :gw * CELL].reshape(gh, CELL, gw, CELL).permute(
        0, 2, 1, 3).reshape(gh * gw, CELL * CELL)
    best = torch.argmax(flat, dim=1)
    best_score = torch.gather(flat, 1, best[:, None])[:, 0]
    cells = torch.arange(gh * gw, device=scores.device)
    y = (cells // gw) * CELL + best // CELL
    x = (cells % gw) * CELL + best % CELL
    k = min(count, gh * gw)
    top_scores, order = torch.sort(best_score, descending=True, stable=True)
    top = order[:k]
    yx = torch.stack([y[top], x[top]], dim=1).to(torch.int32)
    valid = top_scores[:k] > 0
    if k < count:
        yx = torch.cat([yx, torch.zeros((count - k, 2), dtype=torch.int32, device=yx.device)])
        valid = torch.cat([valid, torch.zeros(count - k, dtype=torch.bool, device=yx.device)])
    return yx, valid


def subpixel(raw, yx):
    h, w = raw.shape
    y = yx[:, 0].long().clamp(1, h - 2)
    x = yx[:, 1].long().clamp(1, w - 2)

    def offset(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        off = torch.where(denom.abs() > 1e-9, 0.5 * (sm - sp) / denom, torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    return torch.stack([offset(raw[y - 1, x], raw[y, x], raw[y + 1, x]),
                        offset(raw[y, x - 1], raw[y, x], raw[y, x + 1])], dim=1)


def gaussian_taps(sigma: float = BLUR_SIGMA):
    radius = max(int(round(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32), radius


def blur(image):
    """Separable reflect-padded Gaussian blur, rows then columns, taps
    summed one by one."""
    taps, radius = gaussian_taps()

    def rows(x):
        n = x.shape[0]
        p = F.pad(x[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
        acc = float(taps[0]) * p[0:n]
        for t in range(1, taps.shape[0]):
            acc = acc + float(taps[t]) * p[t:t + n]
        return acc

    return rows(rows(image).T.contiguous()).T.contiguous()


def gather_patches(image, yx):
    """[K, 39, 39] windows of ``image`` centred at ``yx``, edge-clamped."""
    h, w = image.shape
    offs = torch.arange(PATCH_SIZE, device=image.device) - PATCH_GATHER_RADIUS
    rows = (yx[:, 0].long().clamp(0, h - 1)[:, None] + offs).clamp(0, h - 1)
    cols = (yx[:, 1].long().clamp(0, w - 1)[:, None] + offs).clamp(0, w - 1)
    return image[rows[:, :, None], cols[:, None, :]]


def extract(gray_u8, config: dict, dtype=torch.float32) -> Features:
    """The ORB features of one uint8 [H, W] frame (a tensor on the device
    the reference runs on) at the configuration's budget and levels, its
    arithmetic in ``dtype`` (float32, as the configuration states; a lower
    precision for a control)."""
    device = gray_u8.device
    image = gray_u8.to(dtype) / 255.0
    levels, scale = config["orb_levels"], config["orb_scale"]
    budgets = level_budgets(config["orb_features"], levels, scale)
    shapes = level_shapes(*image.shape, levels, scale)
    imgs = [image] + [resize(image, lh, lw) for lh, lw in shapes[1:]]
    wx, wy = (torch.from_numpy(m).to(device, dtype) for m in moment_weights())
    tap1, tap2 = (torch.from_numpy(t).to(device) for t in brief_taps())
    responses = [fast_nms(img, config["fast_threshold"] / 255.0) for img in imgs]
    selected = [select(nms, budget) for (_, nms), budget in zip(responses, budgets)]
    # Every level's patches in one allocation, split by level: the moment
    # products below then read the same addresses' layout a one-launch
    # gather gives, whatever the product's kernel makes of alignment.
    all_patches = torch.cat([gather_patches(blur(img), yx)
                             for img, (yx, _) in zip(imgs, selected)])
    per_level = all_patches.split([yx.shape[0] for yx, _ in selected])
    out = {name: [] for name in Features._fields}
    for level, ((raw, _), (yx, valid), patches) in enumerate(zip(responses, selected,
                                                                   per_level)):
        flat = patches.reshape(patches.shape[0], -1)
        angle = torch.atan2(flat @ wy, flat @ wx)
        q = torch.round(patches * 255.0).clamp(0.0, 255.0).reshape(patches.shape[0], -1)
        step = torch.full_like(angle, 2 * math.pi / BRIEF_ANGLE_BINS)
        bins = torch.remainder(torch.round(angle / step).to(torch.int64), BRIEF_ANGLE_BINS)
        desc = (torch.gather(q, 1, tap1[bins]) < torch.gather(q, 1, tap2[bins])).to(torch.uint8)
        refined = yx.to(torch.float32) + subpixel(raw, yx)
        out["yx"].append(yx)
        out["xy"].append(torch.stack([refined[:, 1], refined[:, 0]], dim=1) * (scale ** level))
        out["angle"].append(angle)
        out["level"].append(torch.full((yx.shape[0],), level, dtype=torch.int32, device=device))
        out["valid"].append(valid)
        out["descriptors"].append(desc)
    return Features(**{k: torch.cat(v) for k, v in out.items()})


def compare(program: dict, ref: Features, config: dict) -> dict:
    """One frame's extracted features against the reference's: keypoint
    slots whose validity, level or position (1e-3 pixels, after undoing
    the normalisation by the camera) differ, and descriptor bits that
    differ in slots that agree."""
    fx, fy, cx, cy = config["fx"], config["fy"], config["cx"], config["cy"]
    kp = np.asarray(program["kp_norm"], np.float64)
    px = np.stack([kp[:, 0] * fx + cx, kp[:, 1] * fy + cy], axis=1)
    valid = np.asarray(program["valid"], bool)
    level = np.asarray(program["level"], np.int64)
    r_xy = ref.xy.double().cpu().numpy()
    r_valid = ref.valid.cpu().numpy()
    r_level = ref.level.cpu().numpy().astype(np.int64)
    same_place = (np.abs(px - r_xy).max(1) <= 1e-3) & (level == r_level)
    slot_ok = (valid == r_valid) & (~r_valid | same_place)
    both = slot_ok & r_valid
    desc = np.asarray(program["desc"], np.uint8)[both]
    r_desc = ref.descriptors.cpu().numpy()[both]
    return {"keypoint_mismatches": int((~slot_ok).sum()),
            "descriptor_bit_mismatches": int((desc != r_desc).sum()),
            "keypoints": int(r_valid.sum())}
