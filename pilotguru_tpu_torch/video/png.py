"""PNG reading and writing on the standard library's zlib, for 8-bit gray,
gray + alpha, RGB and RGBA images (PNG colour types 0, 4, 2 and 6).

The reader undoes all five row filters (None, Sub, Up, Average, Paeth) and
raises ValueError on what it does not read: Adam7 interlacing, bit depths
other than 8, palettes. ``read_png_rgb`` gives what cv2.imread(path,
IMREAD_COLOR) gives after BGR -> RGB: gray repeated over three channels,
alpha dropped. The writer filters every row with one filter type; cv2 (and
any PNG reader) reads its files back to the same pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels, and back.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes and the previous
    scanline's reconstruction (zeros above the first)."""
    if kind == 0:
        return row
    if kind == 1:
        out = row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8)
        return out.reshape(-1)
    if kind == 2:
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG: unknown row filter type {kind}")
    # Average and Paeth depend on the reconstructed byte to the left: one
    # byte at a time, in Python integers.
    out = bytearray(row.tobytes())
    up = prior.tolist()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        else:
            upleft = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], upleft)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image as stored: uint8 [H, W] (gray) or [H, W, C] (C = 2, 3, 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} (palette) is not supported")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, want "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    return out.reshape(height, width) if bpp == 1 else out.reshape(height, width, bpp)


def read_png_rgb(path: str) -> np.ndarray:
    """uint8 [H, W, 3] RGB, as cv2.imread(path, IMREAD_COLOR) then BGR ->
    RGB: gray expands to three equal channels and alpha is dropped."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _filter_rows(img: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Every scanline filtered with ``kind`` (rows of bytes, int16 work)."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, filter_type: str = "sub") -> None:
    """Write uint8 [H, W] (gray) or [H, W, C] (C = 1 gray, 2 gray + alpha,
    3 RGB, 4 RGBA), every row with ``filter_type`` (one of FILTERS),
    compressed at zlib level 1 (on video frames about five times faster
    than level 6, for about 10% more bytes)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"write_png: want uint8 [H, W] or [H, W, C], got {img.dtype} "
                         f"{img.shape}")
    height, width = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    if bpp not in _COLOUR_TYPE:
        raise ValueError(f"write_png: {bpp} channels; want 1, 2, 3 or 4")
    if filter_type not in FILTERS:
        raise ValueError(f"write_png: filter {filter_type!r}; want one of {FILTERS}")
    kind = FILTERS.index(filter_type)
    rows = _filter_rows(np.ascontiguousarray(img).reshape(height, width * bpp), kind, bpp)
    scan = np.concatenate([np.full((height, 1), kind, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[bpp], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(scan.tobytes(), 1)) + _chunk(b"IEND", b""))
