"""The port's native video writer (video/native.py::NativeVideoWriter) over
native/'s libpgvideo, on the CPU: the JAX package's round trip and flip
cases (tests/test_native_video.py), written by the port's writer and read
back by the port's reader, and the writer's checks. The library is built
into this test's own directory, so the JAX test's build of native/build is
not raced; the tests skip where it does not build (no cmake or no libav
headers, as on the card machine).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from pilotguru_tpu_torch.video import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    if shutil.which("cmake") is None:
        pytest.skip("cmake unavailable")
    build = str(tmp_path_factory.mktemp("pgvideo_build"))
    generator = ["-G", "Ninja"] if shutil.which("ninja") else []
    for cmd in (["cmake", "-S", os.path.join(REPO, "native"), "-B", build, *generator],
                ["cmake", "--build", build]):
        if subprocess.run(cmd, capture_output=True).returncode != 0:
            pytest.skip("libpgvideo.so does not build here (libav headers missing?)")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_LIB_PATHS", [os.path.join(build, "libpgvideo.so")])
        mp.setattr(native, "_lib", None)
        assert native.available()
        yield native


def _blocky_frames(seed, count):
    """Smooth blocky frames, which survive lossy encoding recognizably."""
    rng = np.random.default_rng(seed)
    return [np.kron(rng.integers(40, 215, size=(6, 8, 3), dtype=np.uint8),
                    np.ones((8, 8, 1), np.uint8)) for _ in range(count)]


def test_write_read_round_trip(native_lib, tmp_path):
    frames = _blocky_frames(0, 10)
    path = str(tmp_path / "native.mp4")
    with native_lib.NativeVideoWriter(path, width=64, height=48, fps=30) as w:
        for f in frames:
            w.write(f)
    assert os.path.getsize(path) > 0
    with native_lib.NativeVideoReader(path) as r:
        assert (r.width, r.height) == (64, 48)
        decoded = list(r)
    assert len(decoded) == 10
    pts = [p for _, p in decoded]
    assert all(b > a for a, b in zip(pts, pts[1:]))
    for (got, _), want in zip(decoded, frames):
        assert got.shape == want.shape
        assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 12


def test_flips(native_lib, tmp_path):
    path = str(tmp_path / "flip.mp4")
    frame = np.zeros((48, 64, 3), np.uint8)
    frame[:24] = 220  # bright top half
    with native_lib.NativeVideoWriter(path, 64, 48) as w:
        for _ in range(3):
            w.write(frame)
    with native_lib.NativeVideoReader(path, vertical_flip=True) as r:
        got, _ = r.read()
    assert got[:24].mean() < got[24:].mean()


def test_writer_checks(native_lib, tmp_path):
    with pytest.raises(ValueError, match="cannot open video writer"):
        native_lib.NativeVideoWriter(str(tmp_path / "missing" / "dir" / "x.mp4"), 64, 48)
    path = str(tmp_path / "checked.mp4")
    w = native_lib.NativeVideoWriter(path, 64, 48)
    with pytest.raises(ValueError, match=r"expected \(48, 64, 3\) frame"):
        w.write(np.zeros((48, 64), np.uint8))
    w.write(np.zeros((48, 64, 3), np.float64))  # cast to uint8, as the JAX writer does
    w.close()
    w.close()  # a second close is a no-op
    with native_lib.NativeVideoReader(path) as r:
        assert len(list(r)) == 1
