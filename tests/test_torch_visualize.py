"""The port's optical_trajectories CLI with --visualize on the CPU: over the
golden video's first 60 frames written as a PNG image list
(video/io.py::write_image_list), the trajectory JSON of the run with
--visualize is byte-identical to the run without it (the overlay only reads
the tracker), and visualize-0000.mp4 holds every frame of the segment.
The first 40 frames alone make a segment that the flatness test rejects
in both packages (and with it its videos), so these runs take 60. The
port's runs track frame by frame (``track_chunk_frames=0``, ``run_cli``):
at the CLI's default, chunks of 16 through keyframes, the port's own
RANSAC draws make a 60-frame segment that the flatness test rejects too
(tests/test_torch_frame_input.py).

tests/test_torch_visualize_jax.py holds the three flags together against
the JAX CLI on the same list.
"""

import itertools
import os

import cv2
import pytest
import torch

from pilotguru_tpu.vo import pipeline as jax_pipeline
from pilotguru_tpu_torch.cli import optical_trajectories
from pilotguru_tpu_torch.video import io as video_io
from pilotguru_tpu_torch.vo import pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
FRAMES = 60


def golden_image_list(root):
    """The golden video's first FRAMES frames as a gray PNG list."""
    frames = list(itertools.islice(jax_pipeline.video_frames(f"{INPUTS}/video.mp4"), FRAMES))
    return video_io.write_image_list(str(root), [f.gray for f in frames],
                                     [f.time_usec for f in frames])


def run_cli(cli, image_list, out_dir, flags, monkeypatch):
    """``cli``'s main on the list; the port's tracks frame by frame."""
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    if cli is optical_trajectories:
        make = pipeline.tracker_from_settings
        monkeypatch.setattr(pipeline, "tracker_from_settings",
                            lambda *args, **kwargs: make(*args, **{**kwargs, "track_chunk_frames": 0}))
    assert cli.main(["--vocabulary_file=", f"--camera_settings={INPUTS}/camera.yaml",
                     f"--in_video={image_list}", f"--out_dir={out_dir}"] + flags) == 0
    return sorted(os.listdir(out_dir))


def video_frame_count(path):
    capture = cv2.VideoCapture(str(path))
    count = 0
    while capture.read()[0]:
        count += 1
    capture.release()
    return count


@pytest.fixture(scope="module")
def image_list(tmp_path_factory):
    return golden_image_list(tmp_path_factory.mktemp("frames"))


def test_visualize_leaves_the_trajectory_byte_identical(image_list, tmp_path, monkeypatch):
    plain, viz = tmp_path / "plain", tmp_path / "viz"
    assert run_cli(optical_trajectories, image_list, plain, [], monkeypatch) == [
        "trajectory-0000.json"]
    assert run_cli(optical_trajectories, image_list, viz, ["--visualize"], monkeypatch) == [
        "trajectory-0000.json", "visualize-0000.mp4"]
    assert (viz / "trajectory-0000.json").read_bytes() == (
        plain / "trajectory-0000.json").read_bytes()
    assert video_frame_count(viz / "visualize-0000.mp4") == FRAMES
