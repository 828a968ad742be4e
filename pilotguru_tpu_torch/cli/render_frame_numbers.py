"""render_frame_numbers CLI: burn frame ids into a copy of the video (port
of pilotguru_tpu.cli.render_frame_numbers, the reference's
src/render_frame_numbers.cc), used to pick frames to blacklist from
training datasets.

Host drawing and encoding with cv2 (video/render.py, video/io.py); it does
not run where cv2 is missing. --in_video may be a video file or a PNG image
list (video/io.py).
"""

from __future__ import annotations

import sys

from pilotguru_tpu_torch.cli._common import make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--in_video", required=True)
    parser.add_argument("--out_video", required=True)
    parser.add_argument("--frames_to_skip", type=int, default=0)
    parser.add_argument("--max_out_frames", type=int, default=-1)
    parser.add_argument("--output_every_n_frames", type=int, default=1)
    args = parser.parse_args(argv)
    if args.output_every_n_frames <= 0:
        parser.error("--output_every_n_frames must be positive")

    from pilotguru_tpu_torch.video.io import VideoWriterRgb, read_video_rgb, require_cv2
    from pilotguru_tpu_torch.video.render import render_frame_number

    require_cv2("render_frame_numbers")
    total = 0
    skipped = 0
    with VideoWriterRgb(args.out_video) as sink:
        for frame_idx, frame in read_video_rgb(args.in_video):
            if 0 <= args.max_out_frames <= total:
                break
            if skipped < args.frames_to_skip:
                skipped += 1
                continue
            if frame_idx % args.output_every_n_frames == 0:
                sink.consume(render_frame_number(frame.copy(), frame_idx))
                total += 1
    print(f"Total rendered frames: {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
