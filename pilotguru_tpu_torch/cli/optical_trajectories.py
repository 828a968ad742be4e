"""optical_trajectories CLI: monocular visual odometry over a ride video.

Flag-compatible with the reference binary (optical_trajectories.cc:36-62)
and with pilotguru_tpu.cli.optical_trajectories. --vocabulary_file is
parsed and validated but its index is unused (exhaustive Hamming matching
replaces it). --visualize, --output_per_segment_videos and
--visualize_live_port are not ported yet and raise NotImplementedError.
The device comes from PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda).
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument(
        "--vocabulary_file",
        default="",
        help="DBoW2 ORB vocabulary (ORBvoc.txt); validated, index unused.",
    )
    parser.add_argument("--camera_settings", required=True)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--vertical_flip", action="store_true")
    parser.add_argument("--horizontal_flip", action="store_true")
    parser.add_argument("--visualize", action="store_true",
                        help="Not ported yet (raises).")
    parser.add_argument("--output_per_segment_videos", action="store_true",
                        help="Not ported yet (raises).")
    parser.add_argument("--visualize_live_port", type=int, default=None,
                        help="Not ported yet (raises).")
    parser.add_argument("--rotation_smooth_sigma", type=int, default=0)
    parser.add_argument(
        "--image_scale",
        type=float,
        default=1.0,
        help="Optional downscale factor applied before tracking.",
    )
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, dtype = setup_device(args.dtype)

    if args.vocabulary_file:
        from pilotguru_tpu_torch.vo.vocabulary import validate_dbow2_vocabulary

        info = validate_dbow2_vocabulary(args.vocabulary_file, max_nodes=512)
        print(
            f"vocabulary {args.vocabulary_file}: valid DBoW2 "
            f"(k={info.branching_factor}, L={info.depth_levels}, "
            f"{info.num_nodes} nodes). NOTE: the index is NOT used — "
            "relocalization runs exhaustive Hamming matching instead.",
            file=sys.stderr,
        )

    from pilotguru_tpu_torch.vo.camera import read_camera_settings
    from pilotguru_tpu_torch.vo.pipeline import track_video_segments, video_frames

    settings = read_camera_settings(args.camera_settings)
    frames = video_frames(
        args.in_video,
        vertical_flip=args.vertical_flip,
        horizontal_flip=args.horizontal_flip,
        scale=args.image_scale,
    )
    segments, consumed = track_video_segments(
        frames,
        settings,
        args.out_dir,
        rotation_smooth_sigma=args.rotation_smooth_sigma,
        image_scale=args.image_scale,
        per_segment_videos=args.output_per_segment_videos,
        visualize=args.visualize,
        live_view_port=args.visualize_live_port,
        device=device,
        dtype=dtype,
    )
    print(f"{segments} trajectory segment(s) from {consumed} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
