"""Camera settings IO: the reference's OpenCV-YAML calibration format.

The calibrate tool writes a flat FileStorage YAML with Camera_fx..Camera_p2
intrinsics and ORBextractor_* defaults (the reference's src/calibrate.cc:
500-545). This module reads and writes that flat format itself, without
cv2: a ``%YAML:1.0`` or ``%YAML 1.2`` header, ``---``, then one ``key:
value`` line a setting. Reals are written as cv2.FileStorage writes them
(``250.``, ``1.2``, ``1.0000000000000001e-05``, ``.Inf``), so files from
either implementation interchange: cv2 reads these files back to the same
values and this reader gives cv2's values on cv2's files.

A copy of pilotguru_tpu/vo/camera.py's settings, which imports nothing of
JAX but sits in a package whose __init__ does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraSettings:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    fps: float = 30.0
    rgb: bool = True
    orb_features: int = 2000
    orb_scale: float = 1.2
    orb_levels: int = 8
    orb_ini_th_fast: int = 20
    orb_min_th_fast: int = 7


def _parse_scalar(text: str):
    """A plain YAML scalar as cv2.FileStorage reads it: int, real (``250.``,
    ``1.2e-3``, ``.Inf``, ``.Nan``) or string."""
    text = text.strip()
    special = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
    if text.lower() in special:
        return special[text.lower()]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text.strip("'\"")


def read_opencv_yaml(filename: str) -> dict:
    """The top-level ``key: value`` scalars of an OpenCV FileStorage YAML
    file. Nested maps and sequences (indented lines) are skipped; a key
    whose value is one has no entry."""
    try:
        with open(filename) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise ValueError(f"cannot open camera settings file {filename}: {e}") from e
    if not lines or not lines[0].startswith("%YAML"):
        raise ValueError(f"{filename}: not an OpenCV YAML file (no %YAML header)")
    values = {}
    for line in lines[1:]:
        content = line.split("#", 1)[0].rstrip()
        if not content or content in ("---", "...") or content[0] in " \t-":
            continue
        key, sep, value = content.partition(":")
        if not sep:
            raise ValueError(f"{filename}: cannot parse line {line!r}")
        value = value.strip()
        if value and not value.startswith(("!!", "{", "[", "|", ">")):
            values[key.strip()] = _parse_scalar(value)
    return values


def read_camera_settings(filename: str) -> CameraSettings:
    values = read_opencv_yaml(filename)

    def real(key, default=None):
        value = values.get(key)
        if not isinstance(value, (int, float)):
            if default is None:
                raise ValueError(f"missing key {key} in {filename}")
            return default
        return float(value)

    return CameraSettings(
        fx=real("Camera_fx"),
        fy=real("Camera_fy"),
        cx=real("Camera_cx"),
        cy=real("Camera_cy"),
        k1=real("Camera_k1", 0.0),
        k2=real("Camera_k2", 0.0),
        p1=real("Camera_p1", 0.0),
        p2=real("Camera_p2", 0.0),
        fps=real("Camera_fps", 30.0),
        rgb=bool(real("Camera_RGB", 1.0)),
        orb_features=int(real("ORBextractor_nFeatures", 2000)),
        orb_scale=real("ORBextractor_scaleFactor", 1.2),
        orb_levels=int(real("ORBextractor_nLevels", 8)),
        orb_ini_th_fast=int(real("ORBextractor_iniThFAST", 20)),
        orb_min_th_fast=int(real("ORBextractor_minThFAST", 7)),
    )


def format_opencv_real(value: float) -> str:
    """A real as cv2.FileStorage writes it: ``%d.`` when integral within
    int range, ``.Inf`` / ``-.Inf`` / ``.Nan``, else ``%.17g``."""
    if math.isnan(value):
        return ".Nan"
    if math.isinf(value):
        return ".Inf" if value > 0 else "-.Inf"
    if value.is_integer() and -(2 ** 31) <= value < 2 ** 31:
        return f"{int(value)}."
    return f"{value:.17g}"


def write_camera_settings(settings: CameraSettings, filename: str) -> None:
    """Write the flat calibrate.cc format (calibrate.cc:502-545 subset),
    byte for byte as cv2.FileStorage writes it."""
    reals = [("Camera_fx", settings.fx), ("Camera_fy", settings.fy),
             ("Camera_cx", settings.cx), ("Camera_cy", settings.cy),
             ("Camera_k1", settings.k1), ("Camera_k2", settings.k2),
             ("Camera_p1", settings.p1), ("Camera_p2", settings.p2),
             ("Camera_fps", settings.fps)]
    ints = [("Camera_RGB", int(settings.rgb)),
            ("ORBextractor_nFeatures", settings.orb_features)]
    lines = ["%YAML 1.2", "---"]
    lines += [f"{k}: {format_opencv_real(float(v))}" for k, v in reals]
    lines += [f"{k}: {int(v)}" for k, v in ints]
    lines.append(f"ORBextractor_scaleFactor: {format_opencv_real(float(settings.orb_scale))}")
    lines += [f"{k}: {int(v)}" for k, v in (
        ("ORBextractor_nLevels", settings.orb_levels),
        ("ORBextractor_iniThFAST", settings.orb_ini_th_fast),
        ("ORBextractor_minThFAST", settings.orb_min_th_fast))]
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")
