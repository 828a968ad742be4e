"""Colour conversion and INTER_AREA resizing of uint8 frames, on the host
with numpy, bit-equal to OpenCV 5.0's (cv2.cvtColor, cv2.resize).

The JAX package does this work with cv2 (its vo/pipeline.py,
cli/make_steering_dataset.py and ml/prediction.py). These functions repeat
OpenCV's integer and float32 arithmetic step by step, so frames prepared
here equal the reference's to the bit and the port needs no cv2:

- ``rgb_to_gray``: COLOR_RGB2GRAY, ``(9798 R + 19235 G + 3735 B + 2^14)
  >> 15``;
- ``rgb_to_yuv``: COLOR_RGB2YUV, the shift-14 luma and the 0.492 / 0.877
  chroma scales in fixed point;
- ``resize_area``: INTER_AREA for downscaling. Integer factors take
  OpenCV's fast path (block sums; a factor of 2 rounds half up, others
  multiply by the float32 reciprocal of the block's area and round half to
  even); other factors sum float32 weights over each cell, row by row,
  in OpenCV's order, and round half to even.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _channels(rgb: np.ndarray):
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want a uint8 [H, W, 3] RGB image, got {rgb.dtype} {rgb.shape}")
    return [rgb[..., i].astype(np.int32) for i in range(3)]


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB -> uint8 [H, W] luma, as COLOR_RGB2GRAY. The
    coefficients sum to 2^15, so a gray pixel expanded to three equal
    channels converts back to itself."""
    r, g, b = _channels(rgb)
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB -> uint8 [H, W, 3] YUV, as COLOR_RGB2YUV."""
    r, g, b = _channels(rgb)
    half, delta = 1 << 13, 128 << 14
    y = (4899 * r + 9617 * g + 1868 * b + half) >> 14
    u = ((b - y) * 8061 + delta + half) >> 14
    v = ((r - y) * 14369 + delta + half) >> 14
    return np.clip(np.stack([y, u, v], axis=-1), 0, 255).astype(np.uint8)


def _saturate_u8(values: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of floats: round half to even, then clamp."""
    return np.clip(np.rint(values), 0, 255).astype(np.uint8)


def _area_tab(src: int, dst: int, scale: float):
    """computeResizeAreaTab: for each output cell, the source indices it
    covers and their float32 weights, as [dst, n] arrays padded with
    weight 0 (adding 0 leaves a float32 sum unchanged)."""
    cells = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        cell = []
        if s1 - f1 > 1e-3:
            cell.append((s1 - 1, np.float32((s1 - f1) / width)))
        cell.extend((s, np.float32(1.0 / width)) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            cell.append((s2, np.float32(min(min(f2 - s2, 1.0), width) / width)))
        cells.append(cell)
    n = max(len(c) for c in cells)
    index = np.zeros((dst, n), np.int64)
    weight = np.zeros((dst, n), np.float32)
    for d, cell in enumerate(cells):
        for j, (s, w) in enumerate(cell):
            index[d, j], weight[d, j] = s, w
    return index, weight


def _resize_area_general(img: np.ndarray, dw: int, dh: int, sx: float, sy: float):
    """ResizeArea_Invoker<uchar, float>: each source row summed across its
    cells (float32, left to right), then each output row summed down its
    source rows (float32, top to bottom)."""
    xi, xw = _area_tab(img.shape[1], dw, sx)
    yi, yw = _area_tab(img.shape[0], dh, sy)
    src = img.astype(np.float32)
    rows = np.zeros((img.shape[0], dw) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        w = xw[:, j].reshape((1, dw) + (1,) * (img.ndim - 2))
        rows = rows + src[:, xi[:, j]] * w
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        w = yw[:, j].reshape((dh,) + (1,) * (img.ndim - 1))
        out = out + w * rows[yi[:, j]]
    return _saturate_u8(out)


def _resize_area_fast(img: np.ndarray, dw: int, dh: int, kx: int, ky: int):
    """resizeAreaFast_Invoker<uchar, int>: integer factors. Whole kx x ky
    blocks: at 2 x 2 (1, 3 or 4 channels) ``(sum + 2) >> 2``, otherwise
    the int sum times the float32 1 / area, rounded half to even. Output
    pixels whose block runs past the image: the float32 mean of the pixels
    that exist."""
    h, w = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    x = img.astype(np.int64).reshape(h, w, cn)
    out = np.zeros((dh, dw, cn), np.uint8)
    full_w, full_h = min(w // kx, dw), min(h // ky, dh)
    blocks = x[: full_h * ky, : full_w * kx].reshape(full_h, ky, full_w, kx, cn).sum(axis=(1, 3))
    if kx == 2 and ky == 2 and cn in (1, 3, 4):
        out[:full_h, :full_w] = ((blocks + 2) >> 2).astype(np.uint8)
    else:
        out[:full_h, :full_w] = _saturate_u8(
            blocks.astype(np.float32) * np.float32(1.0 / (kx * ky)))
    # The rim: output pixels whose block is cut by the image's edge.
    for dy in range(dh):
        cols = range(dw) if dy >= full_h else range(full_w, dw)
        r0 = dy * ky
        if r0 >= h:
            continue  # the row stays 0
        for dx in cols:
            c0 = dx * kx
            block = x[r0:min(r0 + ky, h), c0:min(c0 + kx, w)]
            count = block.shape[0] * block.shape[1]
            if count:
                out[dy, dx] = _saturate_u8(
                    block.sum(axis=(0, 1)).astype(np.float32) / np.float32(count))
    return out.reshape((dh, dw) + img.shape[2:])


def _upscale_with_cv2(img, dsize, fx, fy):
    """OpenCV emulates INTER_AREA with bilinear weights when a side grows;
    that is not reproduced here, so cv2 (imported here) does it."""
    try:
        import cv2
    except ImportError as e:
        raise ValueError(f"resize_area: {img.shape[1]}x{img.shape[0]} upscaled needs cv2; "
                         "only downscaling is reproduced without it") from e
    return cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_AREA)


def resize_area(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
                fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=cv2.INTER_AREA)
    for a uint8 [H, W] or [H, W, C] image (C <= 4), downscaling only.
    ``dsize`` is (width, height); without it the size is the image's
    times (fx, fy), rounded half to even, and the factors are the ones
    given, as in OpenCV. Upscaling (OpenCV's bilinear emulation of
    INTER_AREA) is not reproduced: cv2 does it, or ValueError without cv2."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] > 4):
        raise ValueError(f"want a uint8 [H, W] or [H, W, C<=4] image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if dsize is not None:
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / w, dh / h
    else:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize_area: give dsize or positive fx and fy")
        dw, dh = int(round(w * fx)), int(round(h * fy))
        inv_x, inv_y = fx, fy
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_area: empty output size {dw}x{dh}")
    if (dw, dh) == (w, h):
        return img.copy()
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx < 1 or sy < 1:
        return _upscale_with_cv2(img, dsize, fx, fy)
    img = np.ascontiguousarray(img)
    kx, ky = int(round(sx)), int(round(sy))
    if abs(sx - kx) < np.finfo(float).eps and abs(sy - ky) < np.finfo(float).eps:
        return _resize_area_fast(img, dw, dh, kx, ky)
    return _resize_area_general(img, dw, dh, sx, sy)
