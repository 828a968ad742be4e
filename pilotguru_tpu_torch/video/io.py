"""TUM-style image-list reading (copied from pilotguru_tpu/video/io.py);
cv2 is imported inside the reader, not with the module."""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


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
    import cv2

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
        bgr = cv2.imread(os.path.join(base, parts[1]), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"cannot read image {parts[1]} from {base}")
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if vertical_flip:
            rgb = rgb[::-1]
        if horizontal_flip:
            rgb = rgb[:, ::-1]
        yield idx, int(round(timestamp_sec * 1e6)), np.ascontiguousarray(rgb)
        idx += 1


def is_image_list(path: str) -> bool:
    """True when ``path`` names a TUM-style image list (an index .txt file
    or a directory holding rgb.txt) rather than a video file."""
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "rgb.txt"))
    return path.endswith(".txt")
