"""The port's fixed-forward-axis calibrator against the JAX package's, on
the CPU in float64, on tests/synthetic.make_ride rides small enough for its
dense (9 + E)^2 solve.

The residuals, the loss and the start agree to 1e-12 (the orientation
chain is the port's doubling-step quaternion scan, which associates
differently from XLA's associative scan); the whole solve to 1e-9 m/s and
1e-9 in the axis: the ride is planar, but the per-event speeds and the
axis magnitude make the normal equations well conditioned, unlike
fit_motion's windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from pilotguru_tpu.calib import forward_axis_calibrator as jfa
from pilotguru_tpu.calib.pieces import build_ride_pieces
from pilotguru_tpu_torch.calib import forward_axis_calibrator as tfa

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_ride():
    return synthetic.make_ride(duration_sec=12.0, imu_hz=10.0, local_bias=(0.05, -0.1, 0.2),
                               jitter_seed=21)


def _args(r):
    return (r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
            r.gps_times_usec, r.gps_speeds)


def test_start_residuals_and_loss_match_reference(small_ride):
    r = small_ride
    ride = build_ride_pieces(*_args(r)[:5])
    num_gps = r.gps_times_usec.shape[0]
    want_x0, want_arrays = jfa.initial_state(ride, r.gps_speeds, num_gps, jnp.float64)
    got_x0, got_arrays = tfa.initial_state(ride, r.gps_speeds, device="cpu")
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    for _ in range(3):
        params = np.asarray(want_x0) + rng.normal(scale=0.1, size=want_x0.shape[0])
        want = jfa.residuals(jnp.asarray(params), want_arrays, ride.num_events, num_gps)
        got = tfa.residuals(torch.as_tensor(params), got_arrays, ride.num_events, num_gps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            float(tfa.loss(torch.as_tensor(params), got_arrays, ride.num_events, num_gps)),
            float(jfa.loss(jnp.asarray(params), want_arrays, ride.num_events, num_gps)),
            rtol=1e-12)


def test_normalization_matches_reference():
    params = np.concatenate([np.arange(6.0), [2.0, -1.0, 0.5], [3.0, 4.0]])
    np.testing.assert_array_equal(tfa.normalize_velocities(params),
                                  jfa.normalize_velocities(params))
    with pytest.raises(ValueError, match="degenerate"):
        tfa.normalize_velocities(np.concatenate([np.zeros(9), [1.0]]))


def test_calibration_matches_reference(small_ride):
    want = jfa.calibrate_fixed_forward_axis(*_args(small_ride), num_iters=30)
    got = tfa.calibrate_fixed_forward_axis(*_args(small_ride), num_iters=30, device="cpu")
    np.testing.assert_array_equal(got.event_times_usec, want.event_times_usec)
    np.testing.assert_allclose(got.velocities, want.velocities, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.forward_axis, want.forward_axis, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.acceleration_global_bias, want.acceleration_global_bias,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.acceleration_local_bias, want.acceleration_local_bias,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=1e-9, atol=1e-15)
    # And it calibrates: the device's forward axis is +x.
    assert got.forward_axis @ np.array([1.0, 0.0, 0.0]) > 0.99


def test_calibration_runs_on_the_card_by_default(small_ride):
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tfa.calibrate_fixed_forward_axis(*_args(small_ride), num_iters=1)
