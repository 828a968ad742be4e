"""video/imgproc.py against cv2 (OpenCV 5.0 here): RGB -> gray, RGB -> YUV
and INTER_AREA downscaling, bit-equal, over integer and non-integer
factors, one, three and four channels, odd sizes, the shapes the CLIs use
and the golden video's frames. Inputs from numpy seeds."""

import os

import cv2
import numpy as np
import pytest

from pilotguru_tpu_torch.video import imgproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = os.path.join(REPO, "tests", "golden", "inputs", "video.mp4")


def _all_rgb_triples():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


def test_gray_and_yuv_on_every_rgb_triple():
    rgb = _all_rgb_triples()
    np.testing.assert_array_equal(imgproc.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(imgproc.rgb_to_yuv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV))


def test_gray_survives_expansion_to_rgb():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(imgproc.rgb_to_gray(np.repeat(gray[..., None], 3, 2)), gray)


def _image(rng, h, w, channels, levels=256):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, levels, shape, dtype=np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("factor", [0.5, 0.75, 1 / 3, 0.25, 0.6, 0.9])
@pytest.mark.parametrize("size", [(240, 320), (241, 323), (17, 33), (55, 77)])
def test_area_by_factor(channels, factor, size):
    """cv2.resize(img, None, fx, fy): the output size rounds half to even
    and the factor is used as given (the CLIs' --image_scale)."""
    rng = np.random.default_rng(hash((channels, factor, size)) % 2**32)
    for levels in (256, 4):  # few levels: many exact halves (ties)
        img = _image(rng, *size, channels, levels)
        want = cv2.resize(img, None, fx=factor, fy=factor, interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(imgproc.resize_area(img, fx=factor, fy=factor), want)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", [((720, 1280), (200, 66)), ((360, 640), (200, 66)),
                                     ((140, 312), (200, 66)), ((243, 323), (161, 121)),
                                     ((100, 151), (50, 50)), ((37, 41), (36, 40)),
                                     ((66, 200), (66, 100))])
def test_area_to_a_size(channels, src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[0])
    img = _image(rng, *src, channels)
    np.testing.assert_array_equal(imgproc.resize_area(img, dst),
                                  cv2.resize(img, dst, interpolation=cv2.INTER_AREA))


def test_random_shapes_and_sizes():
    rng = np.random.default_rng(5)
    for _ in range(60):
        h, w = (int(x) for x in rng.integers(2, 120, 2))
        img = _image(rng, h, w, int(rng.choice([1, 3])), int(rng.choice([2, 256])))
        dsize = (int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1)))
        np.testing.assert_array_equal(imgproc.resize_area(img, dsize),
                                      cv2.resize(img, dsize, interpolation=cv2.INTER_AREA))


def test_golden_video_frames():
    cap = cv2.VideoCapture(VIDEO)
    frames = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        gray = imgproc.rgb_to_gray(rgb)
        np.testing.assert_array_equal(gray, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
        np.testing.assert_array_equal(imgproc.rgb_to_yuv(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV))
        for f in (0.5, 0.75):
            np.testing.assert_array_equal(
                imgproc.resize_area(gray, fx=f, fy=f),
                cv2.resize(gray, None, fx=f, fy=f, interpolation=cv2.INTER_AREA))
        crop = rgb[60:200, 8:]
        np.testing.assert_array_equal(imgproc.resize_area(crop, (200, 66)),
                                      cv2.resize(crop, (200, 66), interpolation=cv2.INTER_AREA))
        frames += 1
    assert frames == 120


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        imgproc.rgb_to_gray(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        imgproc.resize_area(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        imgproc.resize_area(np.zeros((4, 4), np.uint8))
