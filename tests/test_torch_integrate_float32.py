"""The float32 distance of integrate_motion on chip_smoke's 300 s ride with
hills and sensor noise (seed 101): the JAX package's float32 on the CPU
against float64, pinned, beside the port's float32 on the CPU.

The port's float32 once read 0.0069 m/s on the CPU and 0.0358 on one H100,
11 times the JAX package's 0.00316. On the CPU, torch's float32 cos
misrounded the delta quaternions' scalar part, which lies within a few ulps
of 1, in about one gyro step of ten, always the same way, and the
orientation chain carried the bias in its norm; the port now forms that
part as 1 - 2 sin^2(h / 2), correctly rounded on any device, and its delta
quaternions are the JAX package's to the bit on the CPU. On the card,
CUDA's float32 cumsum of the velocity increments drifted 0.091 m/s; the
port now sums them in XLA's blocked order on every device
(integrate_stages.py)."""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from pilotguru_tpu.calib.integrate import integrate_motion_debiased as jax_integrate
from pilotguru_tpu.geometry.quaternion import rotation_rate_to_quat as jax_rate_to_quat
from pilotguru_tpu_torch.calib.integrate import integrate_motion_debiased
from pilotguru_tpu_torch.geometry.quaternion import rotation_rate_to_quat

torch.set_num_threads(2)


def test_float32_distances_on_the_hills_ride():
    arrays, _ = chip_smoke.make_imu_ride(300.0, climb_m_s=1.5, seed=101)
    rot_t, rates, acc_t, accs = arrays[:4]
    t64, jax64 = jax_integrate(rot_t, rates, acc_t, accs, dtype=jnp.float64)
    t32, jax32 = jax_integrate(rot_t, rates, acc_t, accs, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(t64), np.asarray(t32))
    jax_distance = float(np.abs(np.asarray(jax32, np.float64) - np.asarray(jax64)).max())
    # Measured 0.0031575524 on the CPU (XLA's float32 scan).
    assert 0.0025 < jax_distance < 0.0040
    tp, port64 = integrate_motion_debiased(rot_t, rates, acc_t, accs, dtype=torch.float64,
                                           device="cpu")
    _, port32 = integrate_motion_debiased(rot_t, rates, acc_t, accs, dtype=torch.float32,
                                          device="cpu")
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(t64))
    port64, port32 = np.asarray(port64, np.float64), np.asarray(port32, np.float64)
    # The two packages agree in float64 (measured 1.2e-11 m/s).
    assert np.abs(port64 - np.asarray(jax64)).max() < 1e-9
    # The port's float32 on the CPU: measured 0.0031537 m/s (0.0069 before
    # the scalar part was formed from the sine and the velocities summed in
    # XLA's blocked order).
    assert np.abs(port32 - port64).max() < 0.0032


def test_delta_quaternions_are_the_jax_packages_in_float32():
    rng = np.random.default_rng(7)
    rates = rng.normal(0.0, 0.3, (4096, 3))
    dts = rng.uniform(0.002, 0.01, 4096)
    want = np.asarray(jax_rate_to_quat(jnp.asarray(rates, jnp.float32),
                                       jnp.asarray(dts, jnp.float32)))
    got = rotation_rate_to_quat(torch.tensor(rates, dtype=torch.float32),
                                torch.tensor(dts, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    # The scalar part is cos(h) correctly rounded from the float32 h.
    omega = torch.linalg.vector_norm(torch.tensor(rates, dtype=torch.float32), dim=-1)
    half = (omega * torch.tensor(dts, dtype=torch.float32) * 0.5).double().numpy()
    np.testing.assert_array_equal(got[:, 0], np.cos(half).astype(np.float32))
