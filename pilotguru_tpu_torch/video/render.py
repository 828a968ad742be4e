"""Video annotation rendering: steering-wheel overlay and speedometer
tiles (port of pilotguru_tpu/video/render.py).

Host drawing with cv2, imported inside each call that draws, as the JAX
package does (the reference's src/render_motion.cc:99-201 and
render_frame_numbers.cc): rotated steering-wheel panels and a km/h
speedometer below the ride video, and frame ids burnt in for manual frame
blacklisting. The drawing functions do not run where cv2 is missing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pilotguru_tpu_torch.formats.json_io import read_json


def load_per_frame_series(
    json_name: str, root_name: str, units: str, scale: float
) -> Dict[int, float]:
    """{frame_id: value * scale} from an annotate_frames output
    (render_motion.cc:65-77)."""
    root = read_json(json_name)
    return {int(e["frame_id"]): float(e[units]) * scale for e in root[root_name]}


def render_steering(out_frame, row, col, wheel_image, turn_degrees: float):
    """Rotate the wheel image by ``turn_degrees`` and paste it at (row, col)
    (render_motion.cc:99-110). Needs cv2."""
    import cv2

    h, w = wheel_image.shape[:2]
    rot = cv2.getRotationMatrix2D((w / 2, h / 2), turn_degrees, 1.0)
    rotated = cv2.warpAffine(wheel_image, rot, (w, h), flags=cv2.INTER_LINEAR)
    out_frame[row : row + h, col : col + w] = rotated


def render_velocity(out_frame, row, col, window_rows, window_cols, velocity_km_h):
    """Digits and a vertical speedometer bar (render_motion.cc:124-181).
    Needs cv2."""
    import cv2

    panel = out_frame[row : row + window_rows, col : col + window_cols]
    panel[:] = 0
    margin = 10
    text = str(int(velocity_km_h))
    color = (255, 255, 255)
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 3.0, 3)
    cv2.putText(panel, text, (margin, window_rows - margin),
                cv2.FONT_HERSHEY_SIMPLEX, 3.0, color, 3)
    cv2.putText(panel, " km/h", (margin + tw, window_rows - margin),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8, color, 3)
    max_km_h = 100
    full_height = window_rows - th - 3 * margin
    bar_margin = 30
    marked = min(max(int(full_height * velocity_km_h / max_km_h), 1), full_height)
    cv2.rectangle(panel, (bar_margin, margin),
                  (window_cols - bar_margin, margin + full_height), color)
    panel[margin + full_height - marked : margin + full_height,
          bar_margin : window_cols - bar_margin] = 255


def render_frame_number(frame, frame_idx: int):
    """Burn the frame index into the image (render_frame_numbers.cc:53-58).
    Needs cv2."""
    import cv2

    cv2.putText(frame, str(frame_idx), (10, 100), cv2.FONT_HERSHEY_SIMPLEX, 3.0,
                (255, 0, 0), 3)
    return frame


class MotionRenderer:
    """Composites one output frame: the video on top, wheel and speed
    panels below (render_motion.cc:233-285: the left wheel at column 0, the
    right wheel at the right edge, the velocity panels inboard of each)."""

    def __init__(
        self,
        wheel_image: np.ndarray,
        steering_left: Optional[Dict[int, float]] = None,
        steering_right: Optional[Dict[int, float]] = None,
        velocities_left: Optional[Dict[int, float]] = None,
        velocities_right: Optional[Dict[int, float]] = None,
    ):
        self.wheel = wheel_image
        self.steering_left = steering_left
        self.steering_right = steering_right
        self.velocities_left = velocities_left
        self.velocities_right = velocities_right

    def out_shape(self, video_height: int, video_width: int):
        wh, ww = self.wheel.shape[:2]
        return video_height + wh, max(video_width, 4 * ww)

    def render(self, video_frame: np.ndarray, frame_idx: int) -> np.ndarray:
        vh, vw = video_frame.shape[:2]
        oh, ow = self.out_shape(vh, vw)
        out = np.zeros((oh, ow, 3), np.uint8)
        out[:vh, :vw] = video_frame
        wh, ww = self.wheel.shape[:2]

        def lookup(series):
            return None if series is None else series.get(frame_idx)

        left, right = lookup(self.steering_left), lookup(self.steering_right)
        if left is not None:
            render_steering(out, vh, 0, self.wheel, left)
        if right is not None:
            render_steering(out, vh, ow - ww, self.wheel, right)
        v_left, v_right = lookup(self.velocities_left), lookup(self.velocities_right)
        if v_left is not None:
            render_velocity(out, vh, ww, wh, ww, v_left)
        if v_right is not None:
            render_velocity(out, vh, ow - 2 * ww, wh, ww, v_right)
        return out
