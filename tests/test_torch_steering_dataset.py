"""make_steering_dataset: the JAX CLI and the port's CLI on the golden video
on the CPU, with the golden ride's first 120 frame times and the golden
steering / velocity / forward-axis files, at --target_height=66
--target_width=200 after a crop, once in YUV and once in gray. Every npz
array is equal (values and dtypes), and so are the PNGs' pixels."""

import glob
import os

import cv2
import numpy as np
import pytest
import torch

from pilotguru_tpu.cli import make_steering_dataset as jax_cli
from pilotguru_tpu.formats import json_io
from pilotguru_tpu_torch.cli import make_steering_dataset as port_cli
from pilotguru_tpu_torch.video import png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
EXPECTED = os.path.join(REPO, "tests", "golden", "expected")


@pytest.fixture(scope="module")
def ride(tmp_path_factory):
    root = tmp_path_factory.mktemp("ride")
    frames = json_io.read_json(os.path.join(INPUTS, "ride", "frames.json"))
    frames["frames"] = frames["frames"][:120]  # the golden video's frames
    json_io.write_json(frames, str(root / "frames.json"))
    json_io.write_json({"crop_settings": {"crop_top": 60, "crop_bottom": 40, "crop_left": 8,
                                          "crop_right": 0}}, str(root / "crop.json"))
    return root


def _argv(ride, out_dir, colour_flag):
    return [
        f"--in_video={INPUTS}/video.mp4",
        f"--in_frames_json={ride}/frames.json",
        f"--in_steering_json={EXPECTED}/steering.json",
        "--steering_source=imu",
        f"--in_velocities_json={EXPECTED}/velocities.json",
        f"--in_forward_axis_json={EXPECTED}/forward_axis.json",
        f"--crop_settings_json={ride}/crop.json",
        f"--out_dir={out_dir}",
        "--frames_step=3",
        "--frames_history_length=2",
        "--frames_history_step=2",
        "--label_lookahead_frames=0,2",
        "--save_png_every=7",
        "--target_height=66",
        "--target_width=200",
        colour_flag,
    ]


@pytest.mark.parametrize("colour_flag", ["--convert_to_yuv=1", "--convert_to_grayscale=1"])
def test_port_writes_the_jax_examples(ride, tmp_path, monkeypatch, colour_flag):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_cli.main(_argv(ride, jax_dir, colour_flag)) == 0
    assert port_cli.main(_argv(ride, port_dir, colour_flag)) == 0
    names = sorted(os.path.basename(p) for p in glob.glob(str(jax_dir / "*")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(str(port_dir / "*")))
    data = [n for n in names if n.endswith("-data.npz")]
    pngs = [n for n in names if n.endswith(".png")]
    assert len(data) >= 30 and len(pngs) >= 4
    channels = 1 if "grayscale" in colour_flag else 3
    for name in data:
        want, got = np.load(jax_dir / name), np.load(port_dir / name)
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            assert want[key].dtype == got[key].dtype, (name, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        assert got["frame_img"].shape == (2, channels, 66, 200)
        assert got["steering"].shape == (2, 2)
    for name in pngs:
        want = cv2.imread(str(jax_dir / name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(port_dir / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want, err_msg=name)
        if channels == 3:  # cv2 stored RGB from BGR; the port's reader agrees
            np.testing.assert_array_equal(png.read_png(str(port_dir / name)),
                                          cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
