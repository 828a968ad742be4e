"""Camera settings IO: the reference's OpenCV-YAML calibration format.

The calibrate tool writes a flat FileStorage YAML with Camera_fx..Camera_p2
intrinsics and ORBextractor_* defaults (the reference's src/calibrate.cc:
500-545). Read with cv2.FileStorage so files from either implementation
interchange; cv2 is imported only inside the two file functions.

A copy of pilotguru_tpu/vo/camera.py, which imports nothing of JAX but sits
in a package whose __init__ does.
"""

from __future__ import annotations

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


def read_camera_settings(filename: str) -> CameraSettings:
    import cv2

    fs = cv2.FileStorage(filename, cv2.FILE_STORAGE_READ)
    if not fs.isOpened():
        raise ValueError(f"cannot open camera settings file {filename}")

    def real(key, default=None):
        node = fs.getNode(key)
        if node.empty():
            if default is None:
                raise ValueError(f"missing key {key} in {filename}")
            return default
        return node.real()

    try:
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
    finally:
        fs.release()


def write_camera_settings(settings: CameraSettings, filename: str) -> None:
    """Write the flat calibrate.cc format (calibrate.cc:502-545 subset)."""
    import cv2

    fs = cv2.FileStorage(filename, cv2.FILE_STORAGE_WRITE)
    fs.write("Camera_fx", settings.fx)
    fs.write("Camera_fy", settings.fy)
    fs.write("Camera_cx", settings.cx)
    fs.write("Camera_cy", settings.cy)
    fs.write("Camera_k1", settings.k1)
    fs.write("Camera_k2", settings.k2)
    fs.write("Camera_p1", settings.p1)
    fs.write("Camera_p2", settings.p2)
    fs.write("Camera_fps", settings.fps)
    fs.write("Camera_RGB", int(settings.rgb))
    fs.write("ORBextractor_nFeatures", settings.orb_features)
    fs.write("ORBextractor_scaleFactor", settings.orb_scale)
    fs.write("ORBextractor_nLevels", settings.orb_levels)
    fs.write("ORBextractor_iniThFAST", settings.orb_ini_th_fast)
    fs.write("ORBextractor_minThFAST", settings.orb_min_th_fast)
    fs.release()
