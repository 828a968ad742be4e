"""The JAX package's per-frame tracker over the start of chip_smoke's
parallax ride, once per RANSAC key, on the CPU.

    python3 reference_seeds.py [--frames 20] [--keys 0 1 2 3 4] [--float32]

Renders the first ``--frames`` frames of chip_smoke.render_ride (1280x720,
2000 features / 8 levels, fx 700), builds the reference's tracker as its
optical_trajectories CLI does on the CPU (float64, or with ``--float32``
as it does off the CPU; per-frame tracking: ``track_chunk_frames=0``),
sets the tracker's RANSAC key to ``jax.random.PRNGKey(key)`` from outside
and feeds the frames one by one.
Prints one JSON line per key: the state after every frame and the first
frame that is LOST (null if none). This is the reference's side of the
question whether losing track at some RANSAC seed is a property of the
tracker or a fault of the port (ride_seeds.py is the port's side, on the
card).

    python3 reference_seeds.py --fused-golden none twoview@float64

    python3 reference_seeds.py --chunked --ride loop|parallax [--float32]

runs instead the reference's optical_trajectories pipeline at its
defaults (features prefetched in batches of 8, chunks of 16 frames
tracked through keyframes; the fused patch path on the loop ride, as
chip_smoke.py's phase 7c runs the port) over the whole ride, with its own
RANSAC draws, and prints the trajectory's errors against the ride's true
poses (chip_smoke.trajectory_errors) beside the smoke's bars, with its
chunk statistics.

    python3 reference_seeds.py --fused-golden none twoview@float64

runs instead the fused configuration on the golden video as
tests/test_torch_slice_fused.py::test_fused_port_with_its_own_two_view
does (the reference's RANSAC draws replayed, the port's own float32
two-view solve), once with each of ride_seeds.py's swaps in force, and
prints the port's and the JAX run's per-frame rotation error against the
golden trajectory (worst and mean, degrees) beside the test's bar: the JAX
run's worst plus 0.1 degrees.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", "--float32" not in sys.argv)

import chip_smoke  # noqa: E402
from pilotguru_tpu.vo import pipeline, tracking  # noqa: E402
from pilotguru_tpu.vo.camera import CameraSettings  # noqa: E402


def run_key(frames_u8, key):
    settings = CameraSettings(fx=chip_smoke.RIDE_FX, fy=chip_smoke.RIDE_FX,
                              cx=chip_smoke.RIDE_W / 2.0, cy=chip_smoke.RIDE_H / 2.0,
                              orb_features=2000, orb_levels=8)
    base = pipeline.tracker_from_settings(settings)
    tracker = tracking.MonocularTracker(
        base.camera, dataclasses.replace(base.config, track_chunk_frames=0))
    tracker._rng = jax.random.PRNGKey(key)
    states = []
    start = time.perf_counter()
    for i, gray in enumerate(frames_u8):
        states.append(tracker.process_frame(pipeline.gray_as_float(gray), i,
                                            int(round(i * 1e6 / 30.0))))
    lost = [i for i, s in enumerate(states) if s == tracking.LOST]
    return {"key": key, "frames": len(states), "first_lost": lost[0] if lost else None,
            "ok_frames": states.count(tracking.OK), "keyframes": len(tracker.keyframes),
            "states": states, "seconds": time.perf_counter() - start}


def chunked_ride(ride) -> None:
    import os

    from pilotguru_tpu.formats.trajectory import read_trajectory

    if ride == "loop":
        os.environ["PGTPU_PATCH_IMPL"] = "fused"
        frames_u8 = list(chip_smoke.render_loop_ride())
        pose_of, period, bars = chip_smoke.loop_pose, chip_smoke.LOOP_PERIOD, \
            chip_smoke.LOOP_TRUTH_BARS
    else:
        frames_u8 = list(chip_smoke.render_ride())
        pose_of, period, bars = chip_smoke.ride_pose, None, chip_smoke.TRUTH_BARS
    settings = CameraSettings(fx=chip_smoke.RIDE_FX, fy=chip_smoke.RIDE_FX,
                              cx=chip_smoke.RIDE_W / 2.0, cy=chip_smoke.RIDE_H / 2.0,
                              orb_features=2000, orb_levels=8)
    trackers, chunks = [], []
    make, process_chunk = pipeline.tracker_from_settings, tracking.MonocularTracker.process_chunk

    def recording_tracker_from_settings(*args, **kwargs):
        trackers.append(make(*args, **kwargs))
        return trackers[-1]

    def recording_chunk(self, frames):
        results = process_chunk(self, frames)
        chunks.append((min(len(frames), self.config.track_chunk_frames), len(results)))
        return results

    pipeline.tracker_from_settings = recording_tracker_from_settings
    tracking.MonocularTracker.process_chunk = recording_chunk
    with tempfile.TemporaryDirectory() as out:
        start = time.perf_counter()
        segments, consumed = pipeline.track_video_segments(
            (pipeline.VideoFrame(g, i, int(round(i * 1e6 / 30.0)))
             for i, g in enumerate(frames_u8)), settings, out)
        seconds = time.perf_counter() - start
        names = sorted(f for f in os.listdir(out) if f.endswith(".json"))
        trajs = [read_trajectory(os.path.join(out, f)) for f in names]
    longest = max(trajs, key=len) if trajs else None
    errors = chip_smoke.trajectory_errors(longest, pose_of, period) if longest else None
    print(json.dumps({
        "ride": ride, "chunked": True, "x64": jax.config.jax_enable_x64,
        "segments": segments, "frames": consumed,
        "longest_segment": len(longest) if longest else 0,
        "loop_closures": [t.stats["loop_closures"] for t in trackers[1:]],
        "chunks": len(chunks), "frames_per_chunk": sum(c for _, c in chunks) / len(chunks),
        "refed": sum(d - c for d, c in chunks), "seconds": seconds,
        "against_truth": errors, "bars": bars,
        "over": {k: v for k, v in (errors or {}).items() if k in bars and v > bars[k]}}),
        flush=True)


def fused_golden(swaps) -> None:
    import os

    import torch

    sys.path.insert(0, os.path.join(chip_smoke.REPO_DIR, "tests"))
    import ride_seeds
    from test_torch_slice_replay import (
        GOLDEN,
        jax_per_frame_run,
        port_replayed_run,
        rotation_degrees,
    )

    from pilotguru_tpu.formats.trajectory import read_trajectory

    fused = {"PGTPU_PATCH_IMPL": "fused"}
    golden = read_trajectory(GOLDEN)
    with tempfile.TemporaryDirectory() as root:
        ref, _ = jax_per_frame_run(os.path.join(root, "jax"), fused, two_view_log=[])
        ref_rot = rotation_degrees(ref.rotations, golden.rotations)
        for spec in swaps:
            with ride_seeds.swapped(spec):
                port, trackers, calls = port_replayed_run(
                    os.path.join(root, spec.replace("@", "-")), fused,
                    two_view_dtype=torch.float32)
            rot = rotation_degrees(port.rotations, golden.rotations)
            print(json.dumps({
                "fused_golden": spec, "frames": len(port), "two_view_calls": calls["two_view"],
                "loop_closures": [t.stats["loop_closures"] for t in trackers],
                "port_rotation_max_deg": float(rot.max()),
                "port_rotation_mean_deg": float(rot.mean()),
                "jax_rotation_max_deg": float(ref_rot.max()),
                "jax_rotation_mean_deg": float(ref_rot.mean()),
                "bar_max_deg": float(ref_rot.max() + 0.1)}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--float32", action="store_true",
                        help="x64 off: the tracker computes in float32")
    parser.add_argument("--fused-golden", nargs="+", default=None, metavar="SWAP",
                        help="the fused golden-video run under each ride_seeds.py swap")
    parser.add_argument("--chunked", action="store_true",
                        help="the reference's pipeline at its defaults over a whole ride")
    parser.add_argument("--ride", choices=["parallax", "loop"], default="parallax")
    args = parser.parse_args(argv)
    if args.chunked:
        chunked_ride(args.ride)
        return 0
    if args.fused_golden:
        fused_golden(args.fused_golden)
        return 0
    frames = list(chip_smoke.render_ride(frames=args.frames))
    for key in args.keys:
        print(json.dumps({"ride": "parallax", "x64": jax.config.jax_enable_x64,
                          **run_key(frames, key)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
