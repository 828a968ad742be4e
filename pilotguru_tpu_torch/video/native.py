"""ctypes binding of the native libav video IO library
(native/libpgvideo.so), copied from pilotguru_tpu/video/native.py.

The native reader handles rotation metadata and delayed-frame draining like
the reference's libav reader (src/io/image_sequence_reader.cc) and exposes
presentation timestamps; the writer takes the reference sink's encoder
parameters (src/io/image_sequence_writer.cc: 4 Mbps, GOP 12, yuv420p).
``available()`` is False until the library is built
(`cmake -S native -B native/build && cmake --build native/build`), which
needs the libav headers.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build",
                 "libpgvideo.so"),
    "libpgvideo.so",
]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for path in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(path) if os.path.sep in path else path)
            break
        except OSError:
            lib = None
    if lib is None:
        raise RuntimeError(
            "libpgvideo.so not found; build it with "
            "`cmake -S native -B native/build && cmake --build native/build`"
        )
    lib.pg_video_reader_open.restype = ctypes.c_void_p
    lib.pg_video_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.pg_video_reader_width.argtypes = [ctypes.c_void_p]
    lib.pg_video_reader_height.argtypes = [ctypes.c_void_p]
    lib.pg_video_reader_rotation.argtypes = [ctypes.c_void_p]
    lib.pg_video_reader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pg_video_reader_close.argtypes = [ctypes.c_void_p]
    lib.pg_video_writer_open.restype = ctypes.c_void_p
    lib.pg_video_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int64,
    ]
    lib.pg_video_writer_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.pg_video_writer_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class NativeVideoReader:
    def __init__(self, path: str, vertical_flip=False, horizontal_flip=False):
        lib = _load()
        self._lib = lib
        self._handle = lib.pg_video_reader_open(
            path.encode(), int(vertical_flip), int(horizontal_flip)
        )
        if not self._handle:
            raise ValueError(f"cannot open video {path}")
        self.width = lib.pg_video_reader_width(self._handle)
        self.height = lib.pg_video_reader_height(self._handle)
        self.rotation = lib.pg_video_reader_rotation(self._handle)

    def read(self) -> Optional[Tuple[np.ndarray, int]]:
        """Next (rgb [H, W, 3] uint8, pts_usec), or None at end of stream."""
        frame = np.empty((self.height, self.width, 3), np.uint8)
        pts = ctypes.c_int64(0)
        status = self._lib.pg_video_reader_next(
            self._handle,
            frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(pts),
        )
        if status == 0:
            return None
        if status < 0:
            raise RuntimeError("video decode error")
        return frame, int(pts.value)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        while True:
            item = self.read()
            if item is None:
                return
            yield item

    def close(self):
        if self._handle:
            self._lib.pg_video_reader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()


class NativeVideoWriter:
    """An RGB mp4 sink: ``write`` takes [height, width, 3] uint8 frames;
    ``close`` flushes the encoder and raises if that fails."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 bit_rate: int = 4 * 1024 * 1024):
        lib = _load()
        self._lib = lib
        self.width, self.height = width, height
        self._handle = lib.pg_video_writer_open(
            path.encode(), width, height, float(fps), int(bit_rate)
        )
        if not self._handle:
            raise ValueError(f"cannot open video writer {path}")

    def write(self, rgb: np.ndarray) -> None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"expected {(self.height, self.width, 3)} frame")
        if self._lib.pg_video_writer_write(
            self._handle, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        ) < 0:
            raise RuntimeError("video encode error")

    def close(self):
        if self._handle:
            status = self._lib.pg_video_writer_close(self._handle)
            self._handle = None
            if status < 0:
                raise RuntimeError("video encoder flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()
