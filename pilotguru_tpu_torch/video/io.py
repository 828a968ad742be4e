"""Frame input: TUM-style image lists and video files, as RGB frames.

The routes, in order, none of which needs cv2 but the last:

1. an image list (an index .txt file or a directory holding rgb.txt):
   PNG frames through ``video/png.py``;
2. a video file through the native libav reader (``video/native.py``),
   when ``native/build/libpgvideo.so`` is built;
3. a video file through cv2.VideoCapture, imported inside the call.

When no route can open the input, the error names the routes tried.

Writing a video (``VideoWriterRgb``) needs cv2, imported in the call: the
tools that draw or encode (render_*, predict_live's --log_dir, the VO
CLI's videos) do not run where cv2 is missing, and ``require_cv2`` makes
them say so before any work starts.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Iterator, Tuple

import numpy as np

from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.video.png import read_png_rgb, write_png


def _read_image_rgb(path: str) -> np.ndarray:
    """One image file as uint8 RGB: PNG on zlib, any other format through
    cv2 (imported here)."""
    with open(path, "rb") as f:
        is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if is_png:
        return read_png_rgb(path)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{path}: not a PNG, and no cv2 to read other image formats "
                           "(routes tried: the zlib PNG reader, cv2.imread)") from e
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"cannot read image {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _flipped(rgb: np.ndarray, vertical_flip: bool, horizontal_flip: bool) -> np.ndarray:
    if vertical_flip:
        rgb = rgb[::-1]
    if horizontal_flip:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)


def read_image_list_rgb(
    path: str, vertical_flip: bool = False, horizontal_flip: bool = False
) -> Iterator[Tuple[int, int, np.ndarray]]:
    """The reference's LoadImages (src/io/image_sequence_reader.cc:19-46):
    an index file whose first three lines are headers and whose remaining
    lines are ``<timestamp_seconds> <image_path>``, image paths relative to
    the index file's directory. ``path`` may be the index file itself or a
    directory holding ``rgb.txt`` (the TUM dataset convention).

    Yields (frame_index, time_usec, rgb_frame); flips mirror
    FlippedImageSequenceSource (image_sequence_reader.cc:48-60)."""
    if os.path.isdir(path):
        path = os.path.join(path, "rgb.txt")
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        lines = f.read().splitlines()
    idx = 0
    for line in lines[3:]:  # the reference skips exactly three header lines
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"malformed image-list line: {line!r}")
        timestamp_sec = float(parts[0])
        rgb = _read_image_rgb(os.path.join(base, parts[1]))
        yield idx, int(round(timestamp_sec * 1e6)), _flipped(rgb, vertical_flip,
                                                             horizontal_flip)
        idx += 1


def write_image_list(path: str, frames, times_usec) -> str:
    """Write ``frames`` (uint8 [H, W] gray or [H, W, 3] RGB) as PNGs (gray
    ones as PNG colour type 0) with a TUM index ``rgb.txt`` in directory
    ``path``; returns the index's path."""
    os.makedirs(path, exist_ok=True)
    lines = ["# images", "# file: pilotguru image list", "# timestamp filename"]
    for i, (frame, t) in enumerate(zip(frames, times_usec)):
        name = f"{i:06d}.png"
        write_png(os.path.join(path, name), frame)
        lines.append(f"{t / 1e6:.6f} {name}")
    index = os.path.join(path, "rgb.txt")
    with open(index, "w") as f:
        f.write("\n".join(lines) + "\n")
    return index


def _read_video_cv2(path: str, vertical_flip: bool, horizontal_flip: bool):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frame_id = 0
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            msec = cap.get(cv2.CAP_PROP_POS_MSEC)
            time_usec = int(msec * 1000) if msec > 0 else int(frame_id / fps * 1e6)
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            yield frame_id, time_usec, _flipped(rgb, vertical_flip, horizontal_flip)
            frame_id += 1
    finally:
        cap.release()


def read_frames_rgb(
    path: str, vertical_flip: bool = False, horizontal_flip: bool = False
) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (frame_index, time_usec, rgb_frame) from an image list or a
    video file, by the first route of the module docstring that applies."""
    if is_image_list(path):
        yield from read_image_list_rgb(path, vertical_flip, horizontal_flip)
        return
    if native_video.available():
        with native_video.NativeVideoReader(path, vertical_flip, horizontal_flip) as reader:
            for frame_id, (rgb, pts_usec) in enumerate(reader):
                yield frame_id, pts_usec, rgb
        return
    try:
        import cv2  # noqa: F401  (the last route)
    except ImportError as e:
        raise RuntimeError(
            f"no decoder for {path}: routes tried: an image list (not one), the native "
            "libav reader (libpgvideo.so not built: native/CMakeLists.txt), cv2 (not "
            "importable). Write the frames as a PNG image list (rgb.txt) to run without "
            "a codec."
        ) from e
    yield from _read_video_cv2(path, vertical_flip, horizontal_flip)


def read_video_rgb(
    path: str, vertical_flip: bool = False, horizontal_flip: bool = False
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_index, rgb_frame); flips mirror FlippedImageSequenceSource
    (image_sequence_reader.cc:48-60). The JAX package's read_video_rgb opens
    video files with cv2 only; this one takes read_frames_rgb's routes and
    so also accepts a PNG image list, which lets the CLIs that read frames
    run on a machine without a codec."""
    for frame_id, _, rgb in read_frames_rgb(path, vertical_flip, horizontal_flip):
        yield frame_id, rgb


def is_image_list(path: str) -> bool:
    """True when ``path`` names a TUM-style image list (an index .txt file
    or a directory holding rgb.txt) rather than a video file."""
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "rgb.txt"))
    return path.endswith(".txt")


def require_cv2(tool: str) -> None:
    """Raise, naming ``tool``, when cv2 cannot be imported (checked without
    importing it)."""
    if importlib.util.find_spec("cv2") is None:
        raise RuntimeError(
            f"{tool} needs cv2 (OpenCV's Python package) to draw, encode or "
            "calibrate, and it is not installed"
        )


class VideoWriterRgb:
    """mp4v sink for RGB frames, opened at the first frame like the
    reference's ImageSequenceVideoFileSink (image_sequence_writer.cc:26-87);
    the JAX package's class of the same name. Does not run where cv2 is
    missing."""

    def __init__(self, path: str, fps: float = 30.0):
        self._path = path
        self._fps = fps
        self._writer = None

    def consume(self, rgb_frame: np.ndarray) -> None:
        import cv2

        if self._writer is None:
            h, w = rgb_frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self._path, cv2.VideoWriter_fourcc(*"mp4v"), self._fps, (w, h))
            if not self._writer.isOpened():
                raise ValueError(f"cannot open video writer for {self._path}")
        self._writer.write(cv2.cvtColor(np.ascontiguousarray(rgb_frame),
                                        cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()
