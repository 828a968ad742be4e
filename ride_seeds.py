"""The smoke's rides over several RANSAC generator seeds, on one NVIDIA card.

    python3 ride_seeds.py --ride loop --seeds 0 1 2 3 4 [--loop-closing off]
        [--frames N] [--device cuda|cpu] [--dtype float32|float64]

Renders chip_smoke's parallax ride or loop ride at 1280x720, runs
optical_trajectories' segment loop on CUDA at 2000 features / 8 levels
(the parallax ride with blur-then-gather, the loop ride with the fused blur
+ patch gather, as chip_smoke runs them), once per seed of the tracker's
RANSAC generator, and prints one JSON line per run: segments, the frames of
the longest segment, loop closures, frames/s, and that segment's errors
against the ride's true poses (chip_smoke.trajectory_errors). The smoke's
loop-ride bars sit just above the worst reading of seeds 0 to 4. Unlike
the smoke, a run that loses track or misses a bar is reported, not raised.
``--frames`` keeps the start of the ride only; ``--device cpu`` runs the
plain versions of the kernels on the CPU (a check of the tracker's
decisions, not a measurement), in float64 unless ``--dtype`` says
otherwise (the card runs float32): reference_seeds.py runs the JAX
package's tracker over the same frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import torch

import chip_smoke
from pilotguru_tpu_torch.formats.trajectory import read_trajectory
from pilotguru_tpu_torch.vo import pipeline


def run_seed(frames_u8, seed, patch_impl, loop_closing, pose_of, period, device="cuda",
             dtype=None):
    settings = chip_smoke.ride_settings()
    trackers = []
    make = pipeline.tracker_from_settings

    def seeded_tracker_from_settings(*args, **kwargs):
        tracker = make(*args, **kwargs)
        tracker.config = dataclasses.replace(tracker.config,
                                             enable_loop_closing=loop_closing)
        tracker._generator.manual_seed(seed)
        trackers.append(tracker)
        return tracker

    out_dir = tempfile.mkdtemp(prefix="pg_ride_seeds_")
    pipeline.tracker_from_settings = seeded_tracker_from_settings
    try:
        start = time.perf_counter()
        segments, consumed = pipeline.track_video_segments(
            (pipeline.VideoFrame(g, i, int(round(i * 1e6 / 30.0)))
             for i, g in enumerate(frames_u8)),
            settings, out_dir, device=device, dtype=dtype, patch_impl=patch_impl,
        )
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        trajs = [read_trajectory(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))]
    finally:
        pipeline.tracker_from_settings = make
        shutil.rmtree(out_dir, ignore_errors=True)
    row = {"seed": seed, "loop_closing": loop_closing, "device": device,
           "dtype": str(trackers[0].dtype), "segments": segments,
           "frames": consumed, "frames_per_s": consumed / seconds,
           "loop_closures": [t.stats["loop_closures"] for t in trackers],
           "keyframes": [len(t.keyframes) for t in trackers]}
    if trajs:
        longest = max(trajs, key=len)
        row["longest_segment"] = [int(longest.frame_id[0]), int(longest.frame_id[-1])]
        row["errors"] = chip_smoke.trajectory_errors(longest, pose_of, period)
    return row


def _frames(args) -> dict:
    return {} if args.frames is None else {"frames": args.frames}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ride", choices=["parallax", "loop"], default="loop")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--loop-closing", choices=["on", "off"], default="on")
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--dtype", choices=["float32", "float64"], default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("ride_seeds measures the card: no CUDA device")
        print(f"card: {chip_smoke.card_name_and_power()}", flush=True)
    if args.ride == "loop":
        frames = list(chip_smoke.render_loop_ride(**_frames(args)))
        patch_impl, pose_of, period = "fused", chip_smoke.loop_pose, chip_smoke.LOOP_PERIOD
    else:
        frames = list(chip_smoke.render_ride(**_frames(args)))
        patch_impl, pose_of, period = "blur_then_gather", chip_smoke.ride_pose, None
    for seed in args.seeds:
        row = run_seed(frames, seed, patch_impl, args.loop_closing == "on", pose_of, period,
                       args.device, args.dtype and getattr(torch, args.dtype))
        print(json.dumps({"ride": args.ride, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
