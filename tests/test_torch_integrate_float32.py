"""The float32 distance of integrate_motion on chip_smoke's 300 s ride with
hills and sensor noise (seed 101): the JAX package's float32 on the CPU
against float64, pinned, beside the port's float32 on the CPU. On one H100
the port's float32 reads 0.0358 m/s from the CPU's float64 (PERF.md), 11
times the JAX package's own float32 distance pinned here (0.00316 m/s):
the card's distance is not float32 accumulation that the reference shares
(ROADMAP Queue 3)."""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from pilotguru_tpu.calib.integrate import integrate_motion_debiased as jax_integrate
from pilotguru_tpu_torch.calib.integrate import integrate_motion_debiased

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
    # The port's float32 on the CPU: measured 0.0069 m/s, twice the JAX
    # package's and a fifth of the card's 0.0358.
    assert np.abs(port32 - port64).max() < 0.012
