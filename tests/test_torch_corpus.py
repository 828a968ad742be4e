"""The port's many-ride fit_motion (calib/corpus.py) and preprocess_corpus
CLI against the JAX package's, on the CPU in float64, at the sizes of
tests/test_corpus.py (rides of 40 s and 55 s).

The JAX corpus pads every ride to shape buckets; the port runs each ride at
its own shapes through fit_motion's pieces, so a ride's corpus result is
its fit_motion_arrays result bit for bit. Against the JAX corpus: on rides
with hills, test_torch_fit_motion's 1e-8 m/s; on level rides, where the
solve follows the rounding (test_torch_fit_motion's docstring), the JAX
package's own bar between its corpus and its per-ride path
(tests/test_corpus.py: speeds within rtol 0.02 + 0.1 m/s, mean window loss
within 1.2 times), with the median speed difference within 0.005 m/s, each
RMSE against the true speed under 0.25 m/s and the forward axis within 5
degrees of the true one (+x; on the 55 s ride the JAX corpus's own axis
lies 8.09 degrees from it, the port's 0.28). (Measured at these sizes: the
port 0.044 and 0.223 m/s from the JAX corpus at worst, medians 0.0027 and
0.0008; the JAX per-ride path 0.024 and 0.021 m/s from the JAX corpus.)
"""

import os

import numpy as np
import pytest
import torch

import synthetic
from pilotguru_tpu.calib import corpus as jcorpus
from pilotguru_tpu.calib import fit_motion as jfm
from pilotguru_tpu_torch.calib import corpus as tcorpus
from pilotguru_tpu_torch.calib import fit_motion as tfm
from pilotguru_tpu_torch.cli import preprocess_corpus as tcli
from pilotguru_tpu_torch.formats import json_io as tjson
from test_torch_fit_motion import _angle_deg, ride_3d

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = jcorpus.CorpusBuckets(pieces=2048, windows=16, gps=64, events=2048,
                                window_pieces=32)


def _planar_rides():
    a = synthetic.make_ride(duration_sec=40.0, imu_hz=50.0, local_bias=(0.1, -0.05, 0.2))
    b = synthetic.make_ride(duration_sec=55.0, imu_hz=50.0, base_speed=7.0,
                            heading_amplitude=0.4, local_bias=(-0.05, 0.15, 0.0),
                            t0_usec=3_000_000)
    return [a, b]


def _arrays(ride, pkg):
    return pkg.RideArrays(ride.rot_times_usec, ride.rot_rates, ride.acc_times_usec,
                          ride.accelerations, ride.gps_times_usec, ride.gps_speeds)


def _configs(batch, iters):
    return (jfm.FitMotionConfig(locations_batch_size=batch, locations_shift_step=5,
                                optimization_iters=iters),
            tfm.FitMotionConfig(locations_batch_size=batch, locations_shift_step=5,
                                optimization_iters=iters, device="cpu"))


def test_corpus_matches_reference_with_hills():
    rides = [ride_3d(seed=0), ride_3d(duration_sec=55.0, seed=1)]
    jcfg, tcfg = _configs(15, 30)
    want = jcorpus.fit_motion_corpus([jcorpus.RideArrays(*r) for r in rides], jcfg,
                                     buckets=BUCKETS)
    got = tcorpus.fit_motion_corpus([tcorpus.RideArrays(*r) for r in rides], tcfg)
    assert len(got) == len(rides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.velocity_times_usec, w.velocity_times_usec)
        np.testing.assert_array_equal(g.steering_times_usec, w.steering_times_usec)
        np.testing.assert_allclose(g.steering_angular_velocities,
                                   w.steering_angular_velocities, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.velocities_m_s, w.velocities_m_s, rtol=0, atol=1e-8)
        np.testing.assert_allclose(g.forward_axis, w.forward_axis, rtol=0, atol=1e-8)


def test_corpus_on_planar_rides():
    rides = _planar_rides()
    jcfg, tcfg = _configs(15, 30)
    want = jcorpus.fit_motion_corpus([_arrays(r, jcorpus) for r in rides], jcfg,
                                     buckets=BUCKETS)
    got = tcorpus.fit_motion_corpus([_arrays(r, tcorpus) for r in rides], tcfg)
    for ride, g, w in zip(rides, got, want):
        np.testing.assert_array_equal(g.velocity_times_usec, w.velocity_times_usec)
        np.testing.assert_allclose(g.vertical_axis, w.vertical_axis, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.velocities_m_s, w.velocities_m_s, rtol=0.02, atol=0.1)
        assert np.median(np.abs(g.velocities_m_s - w.velocities_m_s)) <= 0.005
        assert np.mean(g.window_final_loss) <= np.mean(w.window_final_loss) * 1.2 + 1e-6
        truth = ride.speed_at(w.velocity_times_usec)
        assert np.sqrt(np.mean((g.velocities_m_s - truth) ** 2)) < 0.25
        assert _angle_deg(g.forward_axis, np.array([1.0, 0.0, 0.0])) <= 5.0


def test_corpus_equals_per_ride_fit_motion_bit_for_bit():
    arrays = [_arrays(r, tcorpus) for r in _planar_rides()]
    arrays.append(tcorpus.RideArrays(*ride_3d(seed=2)))
    _, tcfg = _configs(10, 8)
    corpus = tcorpus.fit_motion_corpus(arrays, tcfg)
    for ride, c in zip(arrays, corpus):
        s = tfm.fit_motion_arrays(*ride, config=tcfg)
        for field in ("vertical_axis", "steering_times_usec", "steering_angular_velocities",
                      "velocity_times_usec", "velocities_m_s", "forward_axis",
                      "window_params", "window_final_loss"):
            np.testing.assert_array_equal(getattr(c, field), getattr(s, field), field)


def _write_corpus(root, rides):
    for i, ride in enumerate(rides):
        synthetic.write_ride_jsons(ride, str(root / f"ride-{i}"))
    return [root / f"ride-{i}" for i in range(len(rides))]


def test_preprocess_corpus_cli_writes_each_rides_fit(tmp_path, monkeypatch):
    """The CLI's files hold the library's results for each ride (JSON bytes
    as fit_motion's writers make them); --shard_windows on one device runs
    unsharded; --process_can_data converts each ride's CAN log."""
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    rides = _planar_rides()
    dirs = _write_corpus(tmp_path, rides)
    can = open(os.path.join(REPO, "tests", "golden", "inputs", "can.json"), "rb").read()
    for d in dirs:
        (d / "can_frames.json").write_bytes(can)
    assert tcli.find_ride_dirs(str(tmp_path)) == [str(d) for d in dirs]
    assert tcli.main([f"--corpus_dir={tmp_path}", "--locations_batch_size=10",
                      "--locations_shift_step=5", "--optimization_iters=8",
                      "--shard_windows", "--process_can_data=true"]) == 0
    _, tcfg = _configs(10, 8)
    want = tcorpus.fit_motion_corpus([_arrays(r, tcorpus) for r in rides], tcfg)
    for d, w, ride in zip(dirs, want, rides):
        out = d / "postprocessed"
        tjson.write_timestamped_values(w.velocity_times_usec, w.velocities_m_s,
                                       str(tmp_path / "v.json"), "velocities", "speed_m_s")
        tjson.write_timestamped_values(w.steering_times_usec, w.steering_angular_velocities,
                                       str(tmp_path / "s.json"), "steering", "angular_velocity")
        tjson.write_forward_axis(w.forward_axis, str(tmp_path / "f.json"))
        assert (out / "velocities-imu.json").read_bytes() == (tmp_path / "v.json").read_bytes()
        assert (out / "steering-imu.json").read_bytes() == (tmp_path / "s.json").read_bytes()
        assert (out / "forward.json").read_bytes() == (tmp_path / "f.json").read_bytes()
        assert (out / "steering-can.json").is_file() and (out / "velocities-can.json").is_file()
        truth = ride.speed_at(w.velocity_times_usec)
        assert np.sqrt(np.mean((w.velocities_m_s - truth) ** 2)) < 1.0


def test_preprocess_corpus_shards_windows_over_every_card(tmp_path, monkeypatch):
    """Four visible CUDA devices: --shard_windows hands fit_motion_corpus a
    ("windows",) mesh over cuda:0 to cuda:3 (a spy that touches no card);
    it never quietly runs on one."""
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    _write_corpus(tmp_path, _planar_rides()[:1])
    seen = []

    def spy(rides, config, timer=None, mesh=None):
        seen.append((len(rides), config.device, mesh))
        return []

    monkeypatch.setattr(tcorpus, "fit_motion_corpus", spy)
    assert tcli.main([f"--corpus_dir={tmp_path}", "--shard_windows"]) == 0
    (num_rides, device, mesh), = seen
    assert num_rides == 1 and device == "cuda"
    assert mesh.axis_names == ("windows",) and mesh.shape == {"windows": 4}
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))


def test_preprocess_corpus_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    assert tfm.FitMotionConfig().device == "cuda"
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("PILOTGURU_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([f"--corpus_dir={tmp_path}"])
