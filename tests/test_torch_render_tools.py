"""The port's host tools that draw or calibrate with cv2, against the JAX
CLIs on the CPU.

- render_frame_numbers and render_motion: on tests/test_tools.py's tiny
  video (20 noise frames, 64x48) and per-frame JSONs, the decoded output
  frames of the port's CLI equal the JAX CLI's, with the tests/test_tools.py
  argv (and once with the right-hand channels and a resize).
- calibrate on tests/golden/inputs/board.mp4 with tools/make_goldens.py's
  argv: the port's YAML equals tests/golden/expected/camera_calib.yaml byte
  for byte (tests/test_golden.py's bar) and the JAX CLI's. Both run with
  one cv2 thread: with several, cv2's calibrateCamera moves the tenth digit
  of the focal length from run to run (275.917062845 to 275.917062860
  measured), in either package.

Every video read decodes through cv2 (``cv2_decode_route``), the route the
JAX package's read_video_rgb always takes. The port's would take the native
libav reader when native/build/libpgvideo.so exists, and
tests/test_native_video.py may build it while this module runs. At a width
that is not a multiple of 16 (the resized 100x84 output) the two decoders
give different pixels, and the native reader's first decode in a process
may differ from its later ones, so the port's reads would compare decoders
instead of renderers.
"""

import os

import cv2
import numpy as np
import pytest

from pilotguru_tpu.cli import calibrate as jax_calibrate
from pilotguru_tpu.cli import render_frame_numbers as jax_frame_numbers
from pilotguru_tpu.cli import render_motion as jax_motion
from pilotguru_tpu_torch.cli import calibrate, render_frame_numbers, render_motion
from pilotguru_tpu_torch.formats import json_io
from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.video.io import read_video_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
EXPECTED = os.path.join(REPO, "tests", "golden", "expected")


@pytest.fixture(scope="module", autouse=True)
def cv2_decode_route():
    """The port decodes through cv2, as the JAX package does (module
    docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    video = str(root / "tiny.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for frame in np.random.default_rng(0).integers(0, 255, size=(20, 48, 64, 3),
                                                   dtype=np.uint8):
        writer.write(frame)
    writer.release()
    wheel = np.zeros((24, 24, 3), np.uint8)
    cv2.circle(wheel, (12, 12), 10, (0, 255, 0), 2)
    cv2.imwrite(str(root / "wheel.png"), wheel)
    json_io.write_json({"steering": [{"frame_id": i, "steering": 0.5 * i} for i in range(20)]},
                       str(root / "steering.json"))
    json_io.write_json({"velocities": [{"frame_id": i, "speed_m_s": 5.0 + i}
                                       for i in range(20)]}, str(root / "velocities.json"))
    return root, video


def _same_decoded_frames(port_cli, jax_cli, argv_of, tmp_path, count):
    outs = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        outs[name] = str(tmp_path / f"{name}.mp4")
        assert cli.main(argv_of(outs[name])) == 0
    got, want = list(read_video_rgb(outs["port"])), list(read_video_rgb(outs["jax"]))
    assert len(got) == len(want) == count
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


def test_render_frame_numbers_matches_jax(tiny, tmp_path):
    _, video = tiny
    _same_decoded_frames(render_frame_numbers, jax_frame_numbers, lambda out: [
        f"--in_video={video}", f"--out_video={out}", "--frames_to_skip=2",
        "--max_out_frames=5", "--output_every_n_frames=2"], tmp_path, 5)


@pytest.mark.parametrize("side", ["left", "right"])
def test_render_motion_matches_jax(tiny, tmp_path, side):
    root, video = tiny
    extra = [f"--steering_left_json={root}/steering.json",
             f"--velocities_json_left={root}/velocities.json"]
    if side == "right":
        extra = [f"--steering_right_json={root}/steering.json",
                 f"--velocities_json_right={root}/velocities.json",
                 "--steering_right_scale=45", "--target_video_height=60",
                 "--target_video_width=100", "--frames_to_skip=3"]
    frames = _same_decoded_frames(render_motion, jax_motion, lambda out: [
        f"--in_video={video}", f"--steering_wheel={root}/wheel.png", f"--out_video={out}",
        "--max_out_frames=10"] + extra, tmp_path, 10)
    height = 60 if side == "right" else 48
    assert frames[0][1].shape[0] == height + 24 and frames[0][1].shape[1] >= 4 * 24


@pytest.fixture
def one_cv2_thread():
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(threads)


def test_calibrate_writes_the_golden_yaml(tmp_path, one_cv2_thread):
    def argv(out):
        return [f"--input={INPUTS}/board.mp4", "--board_side_width=7",
                "--board_side_height=5", "--square_size=0.03", f"--out_file={out}"]

    assert calibrate.main(argv(tmp_path / "port.yaml")) == 0
    assert jax_calibrate.main(argv(tmp_path / "jax.yaml")) == 0
    got = (tmp_path / "port.yaml").read_bytes()
    assert got == (tmp_path / "jax.yaml").read_bytes()
    with open(os.path.join(EXPECTED, "camera_calib.yaml"), "rb") as f:
        assert got == f.read()
