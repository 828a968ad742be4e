"""integrate_motion CLI: naive dead-reckoning speeds.

Flag- and format-compatible with the reference binary and with
pilotguru_tpu.cli.integrate_motion: integrates the raw merged IMU streams
with no calibration, debiases assuming zero start and end velocity, and
writes {"frames": [{time_usec, speed_m_s}, ...]}. The device comes from
PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda); ``--dtype auto`` is
float64 on the CPU and float32 on CUDA.
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--rotations_json", required=True)
    parser.add_argument("--accelerations_json", required=True)
    parser.add_argument("--out_json", required=True)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, dtype = setup_device(args.dtype)

    from pilotguru_tpu_torch.calib.integrate import integrate_motion_debiased
    from pilotguru_tpu_torch.formats import json_io, keys

    rot_times, rot_rates = json_io.read_timestamped_3d(args.rotations_json, keys.ROTATIONS)
    acc_times, accs = json_io.read_timestamped_3d(args.accelerations_json, keys.ACCELERATIONS)
    times, speeds = integrate_motion_debiased(rot_times, rot_rates, acc_times, accs,
                                              dtype=dtype, device=device)
    # The reference writes this series under the "frames" root
    # (integrate_motion.cc:113-121).
    json_io.write_timestamped_values(times, speeds, args.out_json, keys.FRAMES, keys.SPEED_M_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
