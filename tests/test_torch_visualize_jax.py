"""--visualize, --output_per_segment_videos and --visualize_live_port=0
together: the port's optical_trajectories CLI against the JAX CLI on the
CPU, over the golden video's first 60 frames as a PNG image list
(tests/test_torch_visualize.py has the list and says why 60).

- the same set of files, and each video with the JAX video's frame count
  (the segment video holds the OK-tracked frames, the overlay video every
  frame);
- the per-segment trajectory's frame ids remapped as the JAX CLI remaps
  them (ids index the segment video; the initialization's reference frame
  is dropped) and its times equal;
- the live view answers /state.json, /frame.jpg and / while the ride
  tracks, fetched from the tracking loop at frame 30.
"""

import json
import urllib.request

import pytest
import torch
from test_torch_visualize import FRAMES, golden_image_list, run_cli, video_frame_count

from pilotguru_tpu.cli import optical_trajectories as jax_cli
from pilotguru_tpu.formats.trajectory import read_trajectory
from pilotguru_tpu_torch.cli import optical_trajectories
from pilotguru_tpu_torch.vo import viewer

torch.set_num_threads(1)

FLAGS = ["--visualize", "--output_per_segment_videos"]
FILES = ["trajectory-0000.json", "trajectory-0000.mp4", "visualize-0000.mp4"]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as response:
        return response.status, response.headers.get("Content-Type"), response.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("visualize")
    image_list = golden_image_list(root / "frames")
    fetched = {}
    publish_state = viewer.LiveViewer.publish_state

    def publish_and_fetch(self, tracker, frame_id, state, inliers):
        publish_state(self, tracker, frame_id, state, inliers)
        if frame_id == 30:
            base = f"http://127.0.0.1:{self.port}"
            fetched["state"] = _get(base + "/state.json")
            fetched["frame"] = _get(base + "/frame.jpg")
            fetched["page"] = _get(base + "/")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(viewer.LiveViewer, "publish_state", publish_and_fetch)
        port_files = run_cli(optical_trajectories, image_list, root / "port",
                             FLAGS + ["--visualize_live_port=0"], mp)
    with pytest.MonkeyPatch.context() as mp:
        jax_files = run_cli(jax_cli, image_list, root / "jax", FLAGS, mp)
    return root, port_files, jax_files, fetched


def test_same_files_and_frame_counts(runs):
    root, port_files, jax_files, _ = runs
    assert port_files == jax_files == FILES
    for name in FILES[1:]:
        count = video_frame_count(root / "port" / name)
        assert count == video_frame_count(root / "jax" / name)
        assert count == (FRAMES if name.startswith("visualize") else FRAMES - 1)


def test_segment_ids_remapped_as_the_jax_cli(runs):
    root = runs[0]
    port = read_trajectory(str(root / "port" / "trajectory-0000.json"))
    ref = read_trajectory(str(root / "jax" / "trajectory-0000.json"))
    assert port.frame_id.tolist() == ref.frame_id.tolist() == list(range(FRAMES - 1))
    assert port.time_usec.tolist() == ref.time_usec.tolist()


def test_live_view_served_while_tracking(runs):
    fetched = runs[3]
    status, ctype, body = fetched["state"]
    state = json.loads(body)
    assert status == 200 and "application/json" in ctype
    assert state["frame_id"] == 30 and state["state"] == "OK"
    assert state["inliers"] > 0 and state["map_points"] > 0 and state["keyframes"] >= 2
    assert len(state["keyframe_centers"]) == state["keyframes"]
    status, ctype, body = fetched["frame"]
    assert status == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
    assert b"stream.mjpg" in fetched["page"][2]
