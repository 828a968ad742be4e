"""smooth_heading_directions CLI: re-smooth a trajectory's rotations.

Flag- and format-compatible with the reference binary and with
pilotguru_tpu.cli.smooth_heading_directions: Gaussian-filter the
trajectory quaternions per component (sigma in frames, kernel size
4*sigma+1, renormalized), then recompute the planar directions and turn
angles against the stored horizontal plane. The filtering runs on the
device from PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda); ``--dtype
auto`` is float64 on the CPU and float32 on CUDA.
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--trajectory_in_file", required=True)
    parser.add_argument("--sigma", type=int, required=True)
    parser.add_argument("--trajectory_out_file", required=True)
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    if args.sigma <= 0:
        parser.error("--sigma must be positive")
    device, dtype = setup_device(args.dtype)

    from pilotguru_tpu_torch.formats.trajectory import read_trajectory, write_trajectory
    from pilotguru_tpu_torch.timeseries.smoothing import smooth_quaternion_sequence
    from pilotguru_tpu_torch.vo.flatten import project_directions, turn_angles_from_directions

    trajectory = read_trajectory(args.trajectory_in_file)
    if trajectory.plane is None:
        raise ValueError("input trajectory has no stored plane")
    trajectory.rotations = smooth_quaternion_sequence(
        trajectory.rotations, args.sigma, dtype=dtype, device=device).cpu().numpy()
    trajectory.planar_directions = project_directions(trajectory.rotations, trajectory.plane)
    trajectory.turn_angles = turn_angles_from_directions(trajectory.planar_directions)
    write_trajectory(trajectory, args.trajectory_out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
