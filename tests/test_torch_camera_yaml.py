"""vo/camera.py's OpenCV-YAML settings without cv2, against
cv2.FileStorage: the reader gives cv2's values on the golden file, on a
%YAML:1.0 file and on files cv2 wrote; cv2 reads the writer's files back to
the same values, and the writer's bytes equal cv2's."""

import math
import os

import cv2
import numpy as np
import pytest

from pilotguru_tpu_torch.vo import camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "inputs", "camera.yaml")
CALIB = os.path.join(REPO, "tests", "golden", "expected", "camera_calib.yaml")


def _cv2_values(path):
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    try:
        root = fs.root()
        return {k: root.getNode(k).real() for k in root.keys()}
    finally:
        fs.release()


def _assert_same(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        if math.isnan(value):
            assert math.isnan(ours[key]), key
        else:
            assert float(ours[key]) == value, key


@pytest.mark.parametrize("path", [GOLDEN, CALIB])
def test_reader_gives_cv2_values_on_the_goldens(path):
    _assert_same(camera.read_opencv_yaml(path), _cv2_values(path))
    settings = camera.read_camera_settings(path)
    assert settings.fx == _cv2_values(path)["Camera_fx"]


def test_reader_on_cv2_written_files(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "cv2.yaml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    values = {"a": 1e20, "b": 1 / 3, "c": -0.0, "d": 123456789.0, "e": float("inf"),
              "f": float("-inf"), "g": float("nan"), "h": 2.0 ** 31, "i": 1e16, "j": 1e-5,
              **{f"r{k}": float(v) for k, v in enumerate(rng.normal(0, 1e3, 20))}}
    for key, value in values.items():
        fs.write(key, value)
    fs.write("n", 7)
    fs.write("m", -12)
    fs.release()
    _assert_same(camera.read_opencv_yaml(path), _cv2_values(path))


def test_yaml_1_0_header(tmp_path):
    path = tmp_path / "old.yaml"
    path.write_text("%YAML:1.0\n---\nCamera_fx: 517.3\nCamera_fy: 516.5\nCamera_cx: 318.6\n"
                    "Camera_cy: 255.3  # principal point\nCamera_k1: 2.62e-1\n"
                    "ORBextractor_nFeatures: 1000\n")
    _assert_same(camera.read_opencv_yaml(str(path)), _cv2_values(str(path)))
    s = camera.read_camera_settings(str(path))
    assert (s.fx, s.cy, s.k1, s.orb_features, s.orb_levels) == (517.3, 255.3, 0.262, 1000, 8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writer_bytes_equal_cv2_and_read_back(tmp_path, seed):
    rng = np.random.default_rng(seed)
    settings = camera.CameraSettings(
        fx=float(rng.uniform(100, 2000)), fy=float(rng.choice([700.0, rng.uniform(100, 2000)])),
        cx=float(rng.integers(100, 1000)), cy=float(rng.uniform(100, 600)),
        k1=float(rng.normal(0, 0.1)), k2=float(rng.normal(0, 1e-3)), p1=1e-7, p2=0.0,
        fps=float(rng.choice([30.0, 29.97])), rgb=bool(seed % 2),
        orb_features=int(rng.integers(500, 3000)), orb_scale=1.2, orb_levels=8)
    ours = str(tmp_path / "ours.yaml")
    camera.write_camera_settings(settings, ours)
    theirs = str(tmp_path / "cv2.yaml")
    fs = cv2.FileStorage(theirs, cv2.FILE_STORAGE_WRITE)
    for key, value in (("Camera_fx", settings.fx), ("Camera_fy", settings.fy),
                       ("Camera_cx", settings.cx), ("Camera_cy", settings.cy),
                       ("Camera_k1", settings.k1), ("Camera_k2", settings.k2),
                       ("Camera_p1", settings.p1), ("Camera_p2", settings.p2),
                       ("Camera_fps", settings.fps), ("Camera_RGB", int(settings.rgb)),
                       ("ORBextractor_nFeatures", settings.orb_features),
                       ("ORBextractor_scaleFactor", settings.orb_scale),
                       ("ORBextractor_nLevels", settings.orb_levels),
                       ("ORBextractor_iniThFAST", settings.orb_ini_th_fast),
                       ("ORBextractor_minThFAST", settings.orb_min_th_fast)):
        fs.write(key, value)
    fs.release()
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _assert_same(camera.read_opencv_yaml(ours), _cv2_values(ours))
    assert camera.read_camera_settings(ours) == settings


def test_errors(tmp_path):
    path = tmp_path / "x.yaml"
    path.write_text("%YAML 1.2\n---\nCamera_fy: 1.\n")
    with pytest.raises(ValueError, match="Camera_fx"):
        camera.read_camera_settings(str(path))
    path.write_text("Camera_fx: 1.\n")
    with pytest.raises(ValueError, match="YAML"):
        camera.read_camera_settings(str(path))
    with pytest.raises(ValueError, match="cannot open"):
        camera.read_camera_settings(str(tmp_path / "missing.yaml"))
