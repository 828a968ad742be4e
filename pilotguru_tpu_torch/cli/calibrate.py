"""calibrate CLI: camera calibration from chessboard or circle-grid footage
(port of pilotguru_tpu.cli.calibrate, the reference's src/calibrate.cc,
itself an adapted OpenCV sample).

Host calibration with cv2, imported in the call: the pattern is found in a
video, an image list or a camera (cv2.findChessboardCorners with
cornerSubPix, or findCirclesGrid), cv2.calibrateCamera fits the camera,
and vo/camera.py writes the flat Camera_fx..Camera_p2 + ORBextractor_*
YAML that optical_trajectories reads (calibrate.cc:500-545). The
interactive display flags are accepted and ignored. It does not run where
cv2 is missing.
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import make_parser

PATTERNS = ("CHESSBOARD", "CIRCLES_GRID", "ASYMMETRIC_CIRCLES_GRID")


def detect_pattern(gray, pattern: str, board_size):
    """(found, image points) of ``pattern`` in a gray uint8 frame. Needs
    cv2."""
    import cv2

    if pattern == "CHESSBOARD":
        found, points = cv2.findChessboardCorners(
            gray, board_size,
            flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_FAST_CHECK
            | cv2.CALIB_CB_NORMALIZE_IMAGE,
        )
        if found:
            points = cv2.cornerSubPix(
                gray, points, (11, 11), (-1, -1),
                (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.1),
            )
        return found, points
    if pattern == "CIRCLES_GRID":
        return cv2.findCirclesGrid(gray, board_size)
    if pattern == "ASYMMETRIC_CIRCLES_GRID":
        return cv2.findCirclesGrid(gray, board_size, flags=cv2.CALIB_CB_ASYMMETRIC_GRID)
    raise ValueError(f"unknown pattern {pattern}")


def board_object_points(pattern: str, board_size, square_size: float):
    """The board's corners in its own plane (z = 0), row by row, float32."""
    import numpy as np

    w, h = board_size
    if pattern == "ASYMMETRIC_CIRCLES_GRID":
        pts = [((2 * x + y % 2) * square_size, y * square_size, 0.0)
               for y in range(h) for x in range(w)]
    else:
        pts = [(x * square_size, y * square_size, 0.0) for y in range(h) for x in range(w)]
    return np.asarray(pts, np.float32)


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--board_side_width", type=int, default=7)
    parser.add_argument("--board_side_height", type=int, default=5)
    parser.add_argument("--square_size", type=float, default=-1)
    parser.add_argument("--pattern", default="CHESSBOARD", choices=PATTERNS)
    parser.add_argument("--input", required=True)
    parser.add_argument("--flip_horizontal_axis", type=bool, default=False)
    parser.add_argument("--input_delay", type=int, default=100)  # ignored
    parser.add_argument("--skip_frames", type=int, default=0)
    parser.add_argument("--frames_to_use", type=int, default=25)
    parser.add_argument("--fix_aspect_ratio", type=float, default=1.0)
    parser.add_argument("--assume_zero_tangential_distortion", type=bool, default=True)
    parser.add_argument("--fix_principal_point_at_center", type=bool, default=True)
    parser.add_argument("--out_file", required=True)
    parser.add_argument("--write_extrinsic_parameters", type=bool, default=True)
    parser.add_argument("--show_undistorted_image", type=bool, default=False)
    args = parser.parse_args(argv)
    if args.square_size <= 0:
        parser.error("--square_size must be positive")

    from pilotguru_tpu_torch.video.io import require_cv2

    require_cv2("calibrate")
    import cv2
    import numpy as np

    from pilotguru_tpu_torch.vo.camera import CameraSettings, write_camera_settings

    board_size = (args.board_side_width, args.board_side_height)
    objp = board_object_points(args.pattern, board_size, args.square_size)

    capture = cv2.VideoCapture(int(args.input) if args.input.isdigit() else args.input)
    if not capture.isOpened():
        raise ValueError(f"cannot open calibration input {args.input}")
    object_points, image_points = [], []
    image_size = None
    since_detection = args.skip_frames  # the first detection may come at once
    try:
        while len(image_points) < args.frames_to_use:
            ok, frame = capture.read()
            if not ok:
                break
            if args.flip_horizontal_axis:
                frame = frame[::-1]
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            image_size = (gray.shape[1], gray.shape[0])
            if since_detection < args.skip_frames:
                since_detection += 1
                continue
            found, points = detect_pattern(gray, args.pattern, board_size)
            if found:
                object_points.append(objp)
                image_points.append(points)
                since_detection = 0
    finally:
        capture.release()
    if len(image_points) < 3:
        raise ValueError(f"only {len(image_points)} pattern detections; need at least 3")

    flags = cv2.CALIB_FIX_K4 | cv2.CALIB_FIX_K5
    if args.fix_aspect_ratio > 0:
        flags |= cv2.CALIB_FIX_ASPECT_RATIO
    if args.assume_zero_tangential_distortion:
        flags |= cv2.CALIB_ZERO_TANGENT_DIST
    if args.fix_principal_point_at_center:
        flags |= cv2.CALIB_FIX_PRINCIPAL_POINT
    camera_matrix = np.eye(3)
    camera_matrix[0, 0] = args.fix_aspect_ratio
    rms, camera_matrix, dist, _, _ = cv2.calibrateCamera(
        object_points, image_points, image_size, camera_matrix, np.zeros(8), flags=flags)
    dist = np.ravel(dist)
    print(f"Re-projection error reported by calibrateCamera: {rms}")
    write_camera_settings(
        CameraSettings(
            fx=float(camera_matrix[0, 0]), fy=float(camera_matrix[1, 1]),
            cx=float(camera_matrix[0, 2]), cy=float(camera_matrix[1, 2]),
            k1=float(dist[0]), k2=float(dist[1]), p1=float(dist[2]), p2=float(dist[3]),
        ),
        args.out_file,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
