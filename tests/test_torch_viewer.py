"""The port's live HTTP viewer (vo/viewer.py) with tests/test_viewer.py's
cases, on an ephemeral localhost port, and its state JSON equal to the JAX
package's LiveViewer's for the same tracker."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pilotguru_tpu.vo.viewer import LiveViewer as JaxLiveViewer
from pilotguru_tpu_torch.vo import pose
from pilotguru_tpu_torch.vo.viewer import LiveViewer, _rotvec_matrix


class _FakeKeyframe:
    def __init__(self, pose6):
        self.pose6 = np.asarray(pose6, np.float64)


class _FakeTracker:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.points = rng.normal(size=(64, 3))
        self.point_valid = np.ones(64, bool)
        self.point_valid[50:] = False
        self.keyframes = [_FakeKeyframe([0, 0, 0, 0, 0, 0]),
                          _FakeKeyframe([0, 0.1, 0, 0.5, 0, 1.0])]


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


@pytest.fixture
def live_viewer():
    viewer = LiveViewer(port=0)
    yield viewer
    viewer.close()


def test_publish_and_fetch(live_viewer):
    base = f"http://127.0.0.1:{live_viewer.port}"
    status, ctype, body = _get(base + "/")
    assert status == 200 and "text/html" in ctype and b"stream.mjpg" in body
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/frame.jpg")  # no frame yet
    assert err.value.code == 404

    frame = np.zeros((48, 64, 3), np.uint8)
    frame[:, :, 2] = 200
    live_viewer.publish_frame(frame)
    status, ctype, body = _get(base + "/frame.jpg")
    assert status == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"

    live_viewer.publish_state(_FakeTracker(), frame_id=7, state="OK", inliers=42)
    status, ctype, body = _get(base + "/state.json")
    state = json.loads(body)
    assert status == 200 and "application/json" in ctype
    assert (state["frame_id"], state["inliers"], state["map_points"]) == (7, 42, 50)
    assert len(state["points"]) == 50 and len(state["keyframe_centers"]) == 2
    np.testing.assert_allclose(state["keyframe_centers"][0], [0, 0, 0], atol=1e-9)


def test_state_equals_the_jax_viewers(live_viewer):
    jax_viewer = JaxLiveViewer(port=0)
    try:
        tracker = _FakeTracker()
        tracker.points = np.random.default_rng(5).normal(size=(5000, 3))
        tracker.point_valid = np.ones(5000, bool)  # subsampled to 2000
        for viewer in (live_viewer, jax_viewer):
            viewer.publish_state(tracker, frame_id=3, state="OK", inliers=9)
        assert live_viewer._state == jax_viewer._state
        assert len(live_viewer._state["points"]) <= 2000
    finally:
        jax_viewer.close()


def test_rotvec_matrix_matches_the_pose_module():
    rng = np.random.default_rng(1)
    for _ in range(5):
        r = rng.normal(size=3)
        want = pose.rotvec_to_matrix(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(_rotvec_matrix(r), want, atol=1e-12)


def test_center_reconstruction(live_viewer):
    """-R^T t inverts the world->camera convention of vo/pose.py."""
    pose6 = np.random.default_rng(2).normal(size=6)
    tracker = _FakeTracker()
    tracker.keyframes = [_FakeKeyframe(pose6)]
    live_viewer.publish_state(tracker, 0, "OK", 0)
    center = np.asarray(live_viewer._state["keyframe_centers"][0])
    cam = pose.transform(torch.from_numpy(pose6), torch.from_numpy(center[None, :])).numpy()[0]
    np.testing.assert_allclose(cam, [0, 0, 0], atol=1e-3)
