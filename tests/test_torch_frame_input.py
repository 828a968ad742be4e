"""Frame input without cv2: the port's optical_trajectories CLI in a child
process where cv2 cannot be imported, on a PNG image list of the golden
video's first 60 frames (gray, written with video/png.py), gives the
trajectory of the port's run with cv2 present on the same 60 frames
decoded from the mp4; and video/io.py's routes.

Both runs track frame by frame (``track_chunk_frames=0``; the features
still come through the CLI's prefetcher): at the CLI's default, chunks of
16 through keyframes, the port's own RANSAC draws make a 60-frame segment
that the flatness test rejects (its smallest PCA eigenvalue over 1% of the
middle one), so there is no trajectory to compare.
tests/test_torch_slice.py runs the chunked CLI on the whole video."""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.formats.trajectory import read_trajectory
from pilotguru_tpu_torch.video import io as video_io
from pilotguru_tpu_torch.video.png import write_png
from pilotguru_tpu_torch.vo import pipeline
from pilotguru_tpu_torch.vo.camera import read_camera_settings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
FRAMES = 60

NO_CV2 = (
    "import sys\n"
    "sys.modules['cv2'] = None  # import cv2 now raises ImportError\n"
    "from pilotguru_tpu_torch.cli import optical_trajectories\n"
    "from pilotguru_tpu_torch.vo import pipeline\n"
    "make = pipeline.tracker_from_settings\n"
    "pipeline.tracker_from_settings = (\n"
    "    lambda *args, **kwargs: make(*args, **{**kwargs, 'track_chunk_frames': 0}))\n"
    "code = optical_trajectories.main(sys.argv[1:])\n"
    "assert sys.modules['cv2'] is None\n"
    "sys.exit(code)\n"
)


@pytest.fixture(scope="module")
def golden_start():
    frames = list(itertools.islice(pipeline.video_frames(f"{INPUTS}/video.mp4"), FRAMES))
    assert len(frames) == FRAMES
    return frames


def test_cli_without_cv2_on_a_png_list(golden_start, tmp_path, monkeypatch):
    image_list = video_io.write_image_list(str(tmp_path / "frames"),
                                           [f.gray for f in golden_start],
                                           [f.time_usec for f in golden_start])
    out = tmp_path / "no_cv2"
    env = dict(os.environ, PYTHONPATH=REPO, PILOTGURU_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-c", NO_CV2, f"--camera_settings={INPUTS}/camera.yaml",
         f"--in_video={image_list}", f"--out_dir={out}"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]

    ref = tmp_path / "with_cv2"
    make = pipeline.tracker_from_settings
    monkeypatch.setattr(pipeline, "tracker_from_settings",
                        lambda *args, **kwargs: make(*args, **{**kwargs, "track_chunk_frames": 0}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the child (OMP_NUM_THREADS=1)
    try:
        segments, consumed = pipeline.track_video_segments(
            iter(golden_start), read_camera_settings(f"{INPUTS}/camera.yaml"), str(ref),
            device="cpu", dtype=torch.float64)
    finally:
        torch.set_num_threads(threads)
    assert (segments, consumed) == (1, FRAMES)
    got = read_trajectory(str(out / "trajectory-0000.json"))
    want = read_trajectory(str(ref / "trajectory-0000.json"))
    assert len(got) >= 20
    for field in ("frame_id", "time_usec", "translations", "rotations", "plane"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert not (out / "trajectory-0001.json").exists()


def test_image_list_round_trip_and_flips(tmp_path):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (12, 17, 3), dtype=np.uint8) for _ in range(3)]
    times = [1_000_000, 1_033_367, 1_066_733]
    index = video_io.write_image_list(str(tmp_path), frames, times)
    got = list(video_io.read_frames_rgb(index, vertical_flip=True, horizontal_flip=True))
    assert [g[0] for g in got] == [0, 1, 2] and [g[1] for g in got] == times
    for (_, _, rgb), want in zip(got, frames):
        np.testing.assert_array_equal(rgb, want[::-1, ::-1])
    assert [i for i, _ in video_io.read_video_rgb(str(tmp_path))] == [0, 1, 2]
    gray = list(pipeline.video_frames(str(tmp_path), scale=0.5))
    assert gray[0].gray.shape == (6, 8) and gray[2].time_usec == times[2]


def test_no_decoder_names_the_routes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(video_io.native_video, "available", lambda: False)
    with pytest.raises(RuntimeError, match="routes tried"):
        next(video_io.read_video_rgb(f"{INPUTS}/video.mp4"))
    png_path = tmp_path / "a.png"
    write_png(str(png_path), np.zeros((2, 2), np.uint8))
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff")
    (tmp_path / "rgb.txt").write_text("#\n#\n#\n0.0 a.png\n0.1 b.jpg\n")
    frames = video_io.read_image_list_rgb(str(tmp_path))
    assert next(frames)[2].shape == (2, 2, 3)
    with pytest.raises(RuntimeError, match="not a PNG"):
        next(frames)


DATA_CLIS = (
    "import sys\n"
    "sys.modules['cv2'] = None\n"
    "from pilotguru_tpu_torch.cli import make_steering_dataset, predict_video\n"
    "split = sys.argv.index('--')\n"
    "assert make_steering_dataset.main(sys.argv[1:split]) == 0\n"
    "assert predict_video.main(sys.argv[split + 1:]) == 0\n"
    "assert sys.modules['cv2'] is None\n"
)


def test_dataset_and_inference_clis_without_cv2(tmp_path, monkeypatch):
    """make_steering_dataset and predict_video on an RGB PNG image list in a
    child process without cv2: the same files as in this process."""
    from pilotguru_tpu_torch.formats import json_io
    from pilotguru_tpu_torch.ml import models, training

    rng = np.random.default_rng(3)
    n, t0 = 40, 1_000_000
    times = [t0 + int(i * 1e6 / 30) for i in range(n)]
    video_io.write_image_list(str(tmp_path / "frames"),
                              [rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
                               for _ in range(n)], times)
    json_io.write_json({"frames": [{"frame_id": i, "time_usec": t} for i, t in enumerate(times)]},
                       str(tmp_path / "frames.json"))
    dense = np.arange(t0 - 50_000, times[-1] + 50_000, 10_000)
    json_io.write_json({"steering": [{"time_usec": int(t), "angular_velocity": float(v)}
                                     for t, v in zip(dense, rng.normal(0, 0.1, dense.size))]},
                       str(tmp_path / "steering.json"))
    json_io.write_json({"velocities": [{"time_usec": int(t), "speed_m_s": float(v)}
                                       for t, v in zip(dense, rng.uniform(5, 10, dense.size))]},
                       str(tmp_path / "velocities.json"))
    json_io.write_forward_axis(np.array([1.0, 0.1, 0.0]), str(tmp_path / "forward.json"))
    json_io.write_json({"crop_settings": {"crop_top": 6, "crop_left": 13}},
                       str(tmp_path / "crop.json"))
    net = models.make_network({models.NET_NAME: "toy", models.NET_HEAD_DIMS: 10,
                               models.LABEL_DIMENSIONS: 1},
                              [{"input_name": "forward_axis", "input_dims": 3}], (48, 64, 3))
    training.save_module(net, str(tmp_path / "net.msgpack"))
    json_io.write_json({"net_name": "toy", "target_height": 48, "target_width": 64},
                       str(tmp_path / "settings.json"))

    def argv(out):
        return ([f"--in_video={tmp_path}/frames", f"--in_frames_json={tmp_path}/frames.json",
                 f"--in_steering_json={tmp_path}/steering.json", "--steering_source=imu",
                 f"--in_velocities_json={tmp_path}/velocities.json",
                 f"--in_forward_axis_json={tmp_path}/forward.json",
                 f"--crop_settings_json={tmp_path}/crop.json", f"--out_dir={out}/data",
                 "--frames_step=1", "--target_height=48", "--target_width=64",
                 "--convert_to_yuv=1", "--save_png_every=5", "--"]
                + [f"--in_video={tmp_path}/frames/rgb.txt",
                   f"--forward_axis_json={tmp_path}/forward.json",
                   f"--net_settings_json={tmp_path}/settings.json",
                   f"--in_model_weights={tmp_path}/net.msgpack",
                   f"--out_steering_json={out}/steering.json", "--crop_top=6",
                   "--crop_left=13"])

    env = dict(os.environ, PYTHONPATH=REPO, PILOTGURU_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", DATA_CLIS] + argv(tmp_path / "child"),
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]

    from pilotguru_tpu_torch.cli import make_steering_dataset, predict_video

    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    args = argv(tmp_path / "here")
    split = args.index("--")
    assert make_steering_dataset.main(args[:split]) == 0
    assert predict_video.main(args[split + 1:]) == 0
    names = sorted(os.listdir(tmp_path / "here" / "data"))
    assert len([x for x in names if x.endswith(".npz")]) >= 30
    assert names == sorted(os.listdir(tmp_path / "child" / "data"))
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "here" / "data" / name), np.load(
                tmp_path / "child" / "data" / name)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
        else:
            assert (tmp_path / "here" / "data" / name).read_bytes() == (
                tmp_path / "child" / "data" / name).read_bytes()
    assert (tmp_path / "here" / "steering.json").read_bytes() == (
        tmp_path / "child" / "steering.json").read_bytes()
