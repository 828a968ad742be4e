"""video/png.py against cv2: the reader gives cv2.imread's pixels on files
cv2 wrote, cv2 reads the writer's files back to the same pixels, every row
filter type decodes, and what is not read raises."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from pilotguru_tpu_torch.video import png

SHAPES = [(37, 53), (37, 53, 3), (37, 53, 4), (5, 1), (1, 7, 3), (20, 9, 2)]


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    # Smooth gradients, on which libpng picks the Average and Paeth filters.
    ramp = np.add.outer(np.arange(shape[0]) * 3, np.arange(shape[1]) * 2)
    if len(shape) == 3:
        ramp = np.stack([ramp + 40 * c for c in range(shape[2])], axis=2)
    return noise, (ramp % 256).astype(np.uint8)


def _to_cv2(img):
    if img.ndim == 2 or img.shape[2] == 2:
        return img
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR if img.shape[2] == 3 else cv2.COLOR_RGBA2BGRA)


@pytest.mark.parametrize("shape", [s for s in SHAPES if len(s) == 2 or s[2] != 2])
def test_reads_cv2_files(tmp_path, shape):
    for i, img in enumerate(_images(shape, 0)):
        path = str(tmp_path / f"{i}.png")
        cv2.imwrite(path, _to_cv2(img))
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(
            png.read_png_rgb(path),
            cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("filter_type", png.FILTERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_filter_round_trips_through_cv2(tmp_path, filter_type, shape):
    for i, img in enumerate(_images(shape, 1)):
        path = str(tmp_path / f"{i}.png")
        png.write_png(path, img, filter_type)
        np.testing.assert_array_equal(png.read_png(path), img)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img.ndim == 3 and img.shape[2] == 2:  # cv2 gives gray + alpha as BGRA
            back = back[..., [0, 3]]
        elif img.ndim == 3:
            back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB if img.shape[2] == 3
                                else cv2.COLOR_BGRA2RGBA)
        np.testing.assert_array_equal(back, img)
        with open(path, "rb") as f:
            scan = zlib.decompress(f.read()[41:-16])
        assert scan[0] == png.FILTERS.index(filter_type)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_with_header(tmp_path, depth, colour, interlace):
    header = struct.pack(">IIBBBBB", 2, 2, depth, colour, 0, 0, interlace)
    row = bytes(1 + 2 * (depth // 8) * png._CHANNELS.get(colour, 1))
    data = (png.SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(row * 2)) + _chunk(b"IEND", b""))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    return str(path)


def test_unsupported_files_raise(tmp_path):
    with pytest.raises(ValueError, match="Adam7"):
        png.read_png(_png_with_header(tmp_path, 8, 0, 1))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(_png_with_header(tmp_path, 16, 2, 0))
    with pytest.raises(ValueError, match="palette"):
        png.read_png(_png_with_header(tmp_path, 8, 3, 0))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(bad))
    good = tmp_path / "good.png"
    png.write_png(str(good), np.zeros((3, 3), np.uint8))
    data = bytearray(good.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk
    good.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(str(good))
    with pytest.raises(ValueError):
        png.write_png(str(good), np.zeros((3, 3), np.float32))
