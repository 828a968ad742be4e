"""Naive dead reckoning with endpoint debiasing (port of
pilotguru_tpu/calib/integrate.py; the reference's
src/integrate_motion.cc:57-110): the merged rotation + acceleration streams
are integrated with no calibration (zero biases, zero initial velocity),
then the constant acceleration bias implied by a ride that starts and ends
at rest is removed.
"""

from __future__ import annotations

import numpy as np
import torch

from pilotguru_tpu_torch.geometry.strapdown import integrate_motion
from pilotguru_tpu_torch.timeseries.interval_average import blocked_cumsum
from pilotguru_tpu_torch.timeseries.merge import merge_time_series


def integrate_motion_debiased(
    rot_times_usec,
    rot_rates,
    acc_times_usec,
    accelerations,
    dtype=torch.float64,
    device="cuda",
):
    """(event_times_usec[1:], speeds_m_s[1:]) as integrate_motion.cc
    writes them: merged events 1..E-1 each get the norm of the debiased
    integrated velocity. Computed on ``device`` in ``dtype``; host numpy
    out. The ride-long velocity sum runs in XLA's blocked order, the JAX
    package's on the CPU, on every device."""
    event_times, event_idx = merge_time_series([rot_times_usec, acc_times_usec])
    if event_times.size < 2:
        raise ValueError("need at least 2 merged IMU events")
    rates = np.asarray(rot_rates, np.float64)[event_idx[1:, 0]]
    accs = np.asarray(accelerations, np.float64)[event_idx[1:, 1]]
    dts = np.diff(event_times).astype(np.float64) * 1e-6

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    zero = torch.zeros(3, dtype=dtype, device=device)
    velocities = integrate_motion(put(rates), put(accs), put(dts), zero, zero, zero,
                                  cumsum=blocked_cumsum).velocities

    # v(start) = v(end) = 0: remove the implied constant-acceleration drift
    # in proportion to the elapsed time (integrate_motion.cc:91-110).
    total_sec = (event_times[-1] - event_times[0]) * 1e-6
    bias = velocities[-1] / put(total_sec)
    elapsed = put((event_times[1:] - event_times[0]) * 1e-6)
    speeds = torch.linalg.vector_norm(velocities - bias[None, :] * elapsed[:, None], dim=-1)
    return event_times[1:], speeds.cpu().numpy().astype(np.float64)
