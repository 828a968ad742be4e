"""The port's optical_trajectories CLI end to end on the CPU, against the
golden VO trajectory that the JAX package wrote for the same video
(tests/golden/expected/vo/trajectory-0000.json, tools/make_goldens.py).

The golden came from the JAX CLI's default path (chunks of 16 frames
tracked through keyframes, features prefetched in batches of 8, loop
closing on). Each test runs on two port runs of the CLI (the
``port_trajectory`` fixture's parameters):
- "chunked": the CLI at its defaults, the JAX CLI's configuration, with the
  reference's RANSAC draws replayed
  (test_torch_slice_replay.port_replayed_run). The JAX pipeline at its
  defaults rewrites the golden exactly on this machine, so with the same
  draws the poses differ only through the features (the reference's
  batched extractor picks another keypoint in 1 to 5 slots a frame,
  tests/test_torch_prefetch.py).
- "per_frame": the CLI tracking frame by frame (``track_chunk_frames=0``)
  with the port's own draws, the run these bars were first set on.
The port's own draws at the CLI's defaults are not held here: with the
tracker's seed 0 that run's plane normal is over the 2 degree bar (2.186
degrees; frame by frame 0.503), as RANSAC draws move this video's
trajectory by more than the bars (ROADMAP.md, Queue 3). On this video
neither package closes a loop.

Decode route. Both packages take a frame's time from the native libav
reader's pts when native/build/libpgvideo.so exists, and otherwise truncate
cv2's CAP_PROP_POS_MSEC * 1000, which reads 1 us lower on 41 of this
video's 120 frames (66666 against 66667). The golden was written through
the native route, and tests/test_native_video.py may build the library
while this module runs, so the fixture pins both packages to the cv2 route
(``native_video.available`` -> False), the route the card machine always
takes: the frame times are then the JAX package's ``video_frames`` times
exactly and the golden's within 1 us, whether or not the library exists.

Bars set for this port, with the values measured here (per_frame;
chunked):
- one segment with the golden's 120 frame ids: met, exactly; its times equal
  to the JAX package's on the same decode route, and within 1 us of the
  golden's;
- camera centres after a Sim(3) alignment, RMSE <= 3% of the golden path
  length: met, measured 1.445%; 1.075%;
- plane normal within 2 degrees: met, measured 0.503; 0.396 degrees;
- per-frame rotation: measured max 1.231; 0.556 degrees (mean 0.354; 0.190).
  RANSAC draws alone move this video's rotations by more than 1 degree: the
  JAX package's own per-frame run is 1.402 degrees from the golden. The
  rotation bar that accounts for the draws is
  tests/test_torch_slice_replay.py::test_rotation_against_golden_within_the_draws
  (the port with the reference's draws replayed is no farther from the
  golden than the JAX per-frame run, plus 0.1 degrees). test_per_frame_rotation
  below holds the measured maximum (1.25 degrees) and mean (0.5 degrees):
  on the per_frame run a regression guard on the port's own draws.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_slice_replay import port_replayed_run

from pilotguru_tpu.formats.trajectory import read_trajectory
from pilotguru_tpu.video import native as jax_native_video
from pilotguru_tpu.vo import pipeline as jax_pipeline
from pilotguru_tpu_torch.cli import optical_trajectories
from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.vo import pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
GOLDEN = os.path.join(REPO, "tests", "golden", "expected", "vo", "trajectory-0000.json")


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _sim3_align(src, dst):
    """Umeyama: scale, rotation, translation minimizing |c R src + t - dst|."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    s_c, d_c = src - mu_s, dst - mu_d
    u, d, vt = np.linalg.svd(d_c.T @ s_c / len(src))
    sign = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[2, 2] = -1
    r = u @ sign @ vt
    c = np.trace(np.diag(d) @ sign) / ((s_c ** 2).sum() / len(src))
    return c, r, mu_d - c * r @ mu_s


@pytest.fixture(scope="module")
def cv2_decode_route():
    """Both packages decode the mp4 through cv2 (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        mp.setattr(jax_native_video, "available", lambda: False)
        yield


@pytest.fixture(scope="module", params=["per_frame", "chunked"])
def port_trajectory(cv2_decode_route, tmp_path_factory, request):
    out = str(tmp_path_factory.mktemp("vo"))
    if request.param == "chunked":
        _, trackers, _ = port_replayed_run(out, per_frame=False)
        assert trackers[0].config.track_chunk_frames == 16
        assert sorted(os.listdir(out)) == ["trajectory-0000.json"]
        return read_trajectory(os.path.join(out, "trajectory-0000.json"))
    make = pipeline.tracker_from_settings
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
        mp.setattr(pipeline, "tracker_from_settings",
                   lambda *args, **kwargs: make(*args, **{**kwargs, "track_chunk_frames": 0}))
        rc = optical_trajectories.main([
            "--vocabulary_file=",
            f"--camera_settings={INPUTS}/camera.yaml",
            f"--in_video={INPUTS}/video.mp4",
            f"--out_dir={out}",
            "--dtype=auto",
        ])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["trajectory-0000.json"]
    return read_trajectory(os.path.join(out, "trajectory-0000.json"))


def test_same_frames_and_times(port_trajectory, cv2_decode_route):
    golden = read_trajectory(GOLDEN)
    np.testing.assert_array_equal(port_trajectory.frame_id, golden.frame_id)
    jax_times = [f.time_usec for f in jax_pipeline.video_frames(f"{INPUTS}/video.mp4")]
    np.testing.assert_array_equal(port_trajectory.time_usec, jax_times)
    assert np.abs(port_trajectory.time_usec - golden.time_usec).max() <= 1
    assert len(golden) == 120
    assert not port_trajectory.is_lost.any()
    assert np.isfinite(port_trajectory.translations).all()
    np.testing.assert_allclose(np.linalg.norm(port_trajectory.rotations, axis=1), 1.0,
                               atol=1e-9)


def test_camera_centres_after_sim3_alignment(port_trajectory):
    golden = read_trajectory(GOLDEN)
    c, r, t = _sim3_align(port_trajectory.translations, golden.translations)
    aligned = (c * (r @ port_trajectory.translations.T)).T + t
    rmse = np.sqrt(((aligned - golden.translations) ** 2).sum(1).mean())
    length = np.linalg.norm(np.diff(golden.translations, axis=0), axis=1).sum()
    assert rmse <= 0.03 * length  # measured 1.445% (per_frame), 1.075% (chunked)


def test_plane_normal(port_trajectory):
    golden = read_trajectory(GOLDEN)
    na = np.cross(port_trajectory.plane[0], port_trajectory.plane[1])
    ng = np.cross(golden.plane[0], golden.plane[1])
    cos = abs(na @ ng) / np.linalg.norm(na) / np.linalg.norm(ng)
    assert np.degrees(np.arccos(min(cos, 1.0))) <= 2.0  # measured 0.503, 0.396


def test_per_frame_rotation(port_trajectory):
    golden = read_trajectory(GOLDEN)
    diffs = []
    for qa, qg in zip(port_trajectory.rotations, golden.rotations):
        d = _quat_to_matrix(qa).T @ _quat_to_matrix(qg)
        diffs.append(np.degrees(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1))))
    diffs = np.asarray(diffs)
    # Regression guard (module docstring); the draw-aware bar is in
    # test_torch_slice_replay.py.
    assert diffs.max() <= 1.25  # measured 1.231 (per_frame), 0.556 (chunked)
    assert diffs.mean() <= 0.5  # measured 0.354, 0.190
