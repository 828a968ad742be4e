"""How far rounding alone moves fit_motion on a level road, on the CPU.

    python3 fit_motion_rounding.py [--draws 3]

Runs the JAX package's fit_motion_arrays (float64) on the golden ride
(tests/golden/inputs/ride, the goldens' flags: windows of 20 GPS points
every 5) as it is and ``--draws`` times with its accelerations moved by
1e-15 relative (numpy noise from a seed), then the port's
fit_motion_arrays (float64, CPU) on the unmoved ride, and prints one JSON
line per run: its distance from the reference's unmoved run (speeds at the
same event times, max and median; the forward axis's angle; the largest
difference of a fitted parameter). The golden ride is level (yaw only), so
the Gauss-Newton normal equations are singular in the vertical direction
and the fitted windows follow the rounding: this is the yardstick for the
port's distance from the reference there (tests/test_torch_fit_motion.py).
"""

from __future__ import annotations

import argparse
import json
import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from pilotguru_tpu.calib import fit_motion as jfm  # noqa: E402
from pilotguru_tpu.formats import json_io, keys  # noqa: E402
from pilotguru_tpu_torch.calib import fit_motion as tfm  # noqa: E402

RIDE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "inputs",
                    "ride")


def distance(a, b) -> dict:
    diff = np.abs(a.velocities_m_s - b.velocities_m_s)
    cos = a.forward_axis @ b.forward_axis / (np.linalg.norm(a.forward_axis)
                                             * np.linalg.norm(b.forward_axis))
    return {"speed_max": float(diff.max()), "speed_median": float(np.median(diff)),
            "forward_axis_deg": float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
            "params_max": float(np.abs(a.window_params - b.window_params).max())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=3)
    args = parser.parse_args(argv)
    rot_t, rates = json_io.read_timestamped_3d(f"{RIDE}/rotations.json", keys.ROTATIONS)
    acc_t, accs = json_io.read_timestamped_3d(f"{RIDE}/accelerations.json", keys.ACCELERATIONS)
    gps_t, speeds = json_io.read_gps_velocities(f"{RIDE}/locations.json")
    flags = {"locations_batch_size": 20, "locations_shift_step": 5}
    reference = jfm.fit_motion_arrays(rot_t, rates, acc_t, accs, gps_t, speeds,
                                      jfm.FitMotionConfig(**flags))
    rng = np.random.default_rng(0)
    for draw in range(args.draws):
        moved = accs * (1 + 1e-15 * rng.standard_normal(accs.shape))
        run = jfm.fit_motion_arrays(rot_t, rates, acc_t, moved, gps_t, speeds,
                                    jfm.FitMotionConfig(**flags))
        print(json.dumps({"run": "reference, accelerations moved by 1e-15", "draw": draw,
                          **distance(run, reference)}), flush=True)
    port = tfm.fit_motion_arrays(rot_t, rates, acc_t, accs, gps_t, speeds,
                                 tfm.FitMotionConfig(**flags, device="cpu"))
    print(json.dumps({"run": "port", **distance(port, reference)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
