"""The port's window-sharded corpus (calib/corpus.py and calib/fit_motion.py
with a ``("windows",)`` mesh, preprocess_corpus --shard_windows) on the
CPU, at the sizes of tests/test_torch_corpus.py.

- Over ``[cpu] * k`` for k = 2, 3 and 8 every FitMotionResult field equals
  the unsharded run's to the bit: the windows' blocks are solved and
  replayed apart and gathered back in window order before any
  cross-window sum, and the batched solve and replay treat each window on
  its own (no operation here changes its bits with a block's length;
  k = 8 leaves some blocks one window short).
- Against the JAX package's sharded corpus over the 8 virtual devices of
  tests/conftest.py, on rides with hills, within tests/test_torch_corpus.py's
  bars for that comparison (steering 1e-12 rad/s, speeds and forward axis
  1e-8).
- The CLI with --shard_windows writes the same bytes as without it, on the
  CPU's one device and over a mesh of three CPU devices.
"""

import jax
import numpy as np
import pytest
import torch

from pilotguru_tpu.calib import corpus as jcorpus
from pilotguru_tpu.parallel import mesh as jax_mesh
from pilotguru_tpu_torch.calib import corpus as tcorpus
from pilotguru_tpu_torch.cli import preprocess_corpus as tcli
from pilotguru_tpu_torch.parallel import mesh
from test_torch_corpus import BUCKETS, _arrays, _configs, _planar_rides, _write_corpus
from test_torch_fit_motion import ride_3d

torch.set_num_threads(1)

FIELDS = ("vertical_axis", "steering_times_usec", "steering_angular_velocities",
          "velocity_times_usec", "velocities_m_s", "forward_axis", "window_params",
          "window_final_loss")


def _windows_mesh(k):
    return mesh.make_mesh(("windows",), (k,), ["cpu"] * k)


@pytest.fixture(scope="module")
def rides():
    arrays = [_arrays(r, tcorpus) for r in _planar_rides()]
    arrays.append(tcorpus.RideArrays(*ride_3d(seed=2)))
    return arrays


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_sharded_corpus_equals_unsharded_to_the_bit(rides, k, dtype):
    _, config = _configs(10, 8)
    config = type(config)(**{**config.__dict__, "dtype": dtype})
    unsharded = tcorpus.fit_motion_corpus(rides, config)
    sharded = tcorpus.fit_motion_corpus(rides, config, mesh=_windows_mesh(k))
    assert [u.window_params.shape[0] for u in unsharded] == [8, 11, 8]
    for s, u in zip(sharded, unsharded):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(s, field), getattr(u, field), field)


def test_sharded_corpus_against_the_jax_sharded_corpus():
    rides = [ride_3d(seed=0), ride_3d(duration_sec=55.0, seed=1)]
    jcfg, tcfg = _configs(15, 30)
    jm = jax_mesh.make_mesh(("windows",), (8,), jax.devices())
    want = jcorpus.fit_motion_corpus([jcorpus.RideArrays(*r) for r in rides], jcfg,
                                     buckets=BUCKETS, mesh=jm)
    got = tcorpus.fit_motion_corpus([tcorpus.RideArrays(*r) for r in rides], tcfg,
                                    mesh=_windows_mesh(8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.velocity_times_usec, w.velocity_times_usec)
        np.testing.assert_array_equal(g.steering_times_usec, w.steering_times_usec)
        np.testing.assert_allclose(g.steering_angular_velocities,
                                   w.steering_angular_velocities, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.velocities_m_s, w.velocities_m_s, rtol=0, atol=1e-8)
        np.testing.assert_allclose(g.forward_axis, w.forward_axis, rtol=0, atol=1e-8)


def _cli_bytes(tmp_path, name, rides, extra):
    root = tmp_path / name
    root.mkdir()
    dirs = _write_corpus(root, rides)
    assert tcli.main([f"--corpus_dir={root}", "--locations_batch_size=10",
                      "--locations_shift_step=5", "--optimization_iters=8", *extra]) == 0
    return [{f: (d / "postprocessed" / f).read_bytes()
             for f in ("velocities-imu.json", "steering-imu.json", "forward.json")}
            for d in dirs]


def test_cli_shard_windows_writes_the_unsharded_bytes(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    rides = _planar_rides()
    meshes = []
    real = tcorpus.fit_motion_corpus

    def spy(rides, config, timer=None, mesh=None):
        meshes.append(mesh)
        return real(rides, config, timer=timer, mesh=mesh)

    monkeypatch.setattr(tcorpus, "fit_motion_corpus", spy)
    plain = _cli_bytes(tmp_path, "plain", rides, [])
    assert _cli_bytes(tmp_path, "one", rides, ["--shard_windows"]) == plain
    real_make_mesh = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda names, sizes, devices: real_make_mesh(names, (3,), ["cpu"] * 3))
    assert _cli_bytes(tmp_path, "three", rides, ["--shard_windows"]) == plain
    assert meshes[0] is None
    assert meshes[1].axis_names == ("windows",) and meshes[1].devices == (torch.device("cpu"),)
    assert meshes[2].size == 3
