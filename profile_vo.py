"""Where the VO main path spends its time on the card.

    python3 profile_vo.py [--ride parallax|loop] [--frames N] [--trace DIR]
    python3 profile_vo.py --extract-only [--ride parallax|loop] [--frames N]
    python3 profile_vo.py --loop-configurations [--ride parallax|loop] [--frames N]

Runs one of chip_smoke's synthetic 720p rides (2000 features, 8 levels):
the parallax ride (render_ride, blur-then-gather) or the loop ride
(render_loop_ride, the fused blur + gather, one loop closed near its end)
through the port's segment loop on CUDA, frame by frame (features
extracted inline, ``track_chunk_frames=0``, so that every stage and step
is timed on its own; chip_smoke.py's phase 7c times the loop's default,
chunked with prefetch), and prints, per frame:
- host seconds per stage and per tracker step (each timed section ends with
  ``torch.cuda.synchronize()``, so a step's device work is inside it);
- from ``torch.profiler`` over a steady window of frames: the device's busy
  time (sum of kernel durations) against the window's wall time, kernel
  launches, host-device copies, and the kernels that take the most device
  time.
Writes the window's Chrome trace under ``--trace`` when given.

With ``--extract-only`` it runs the feature extractor alone over the ride's
frames (default 100), with both patch paths in turn, and prints per frame:
host ms (each frame ends with a synchronisation, as the tracker's pull of
the features does), device busy ms, kernels launched, and the launches of
K1, K2 and K3 from their wrappers' counts.

With ``--loop-configurations`` it runs the segment loop over the ride in
turns: frame by frame with the features extracted inline; at its
defaults, chunks of 16 through keyframes with the decode and feature
prefetch threads; the same chunks on features prefetched before the run,
so that no worker thread runs beside the tracker; then frame by frame
again. For each it prints frames/s, the tracking attempts
(``fused_track_step`` calls) with their host ms each, and the chunks.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import shutil
import tempfile
import time

import torch

from chip_smoke import card_name_and_power, render_loop_ride, render_ride, ride_settings
from pilotguru_tpu_torch.vo import tracking
from pilotguru_tpu_torch.vo.pipeline import (
    VideoFrame,
    camera_and_config,
    prefetch_features,
    track_video_segments,
    tracker_from_settings,
)

# Tracker steps timed on their own (host seconds, synchronised).
STEPS = (
    "_track_attempt", "_track_reference_keyframe", "_try_initialize",
    "_map_point_culling", "_dispatch_create_points_all", "_create_new_points",
    "_dispatch_fuse", "_fuse_duplicates", "_local_bundle_adjust",
    "_apply_pending_ba", "_keyframe_culling", "_try_close_loop",
    "_global_bundle_adjust", "_refresh_local_points",
)


def _timed(fn, name, totals):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            totals[name][0] += time.perf_counter() - start
            totals[name][1] += 1
    return wrapper


def extract_only(ride) -> None:
    from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel
    from pilotguru_tpu_torch.vo.features import PATCH_IMPLS, extract_orb_features

    images = [torch.from_numpy(gray).cuda().to(torch.float32) / 255.0 for gray in ride]
    counters = (fast_kernel.COUNTER, patch_kernel.COUNTER, patch_kernel.BLUR_COUNTER)
    for patch_impl in PATCH_IMPLS + PATCH_IMPLS[::-1]:
        for image in images[:5]:
            extract_orb_features(image, num_levels=8, total_budget=2000, patch_impl=patch_impl)
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as profiler:
            start = time.perf_counter()
            for image in images:
                extract_orb_features(image, num_levels=8, total_budget=2000,
                                     patch_impl=patch_impl)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        device = [e for e in profiler.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = len(images)
        print(f"extract only ({patch_impl}), {n} frames: host "
              f"{1e3 * seconds / n:.3f} ms/frame, device busy "
              f"{sum(e.device_time_total for e in device) / 1e3 / n:.3f} ms/frame, "
              f"{sum(e.count for e in device) / n:.1f} kernels and copies per frame; "
              f"launches per frame {({c.name: c.launches / n for c in counters})}",
              flush=True)


def loop_configurations(ride, patch_impl) -> None:
    settings = ride_settings()
    attempts = [0, 0.0]
    step = tracking.fused_track_step

    def counted_step(*args, **kwargs):
        start = time.perf_counter()
        try:
            return step(*args, **kwargs)
        finally:
            attempts[0] += 1
            attempts[1] += time.perf_counter() - start

    def frames():
        return (VideoFrame(g, i, int(round(i * 1e6 / 30.0))) for i, g in enumerate(ride))

    def per_frame():
        return tracker_from_settings(settings, device="cuda", patch_impl=patch_impl,
                                     track_chunk_frames=0)

    def chunked():
        return tracker_from_settings(settings, device="cuda", patch_impl=patch_impl)

    def run(name, source, **options):
        attempts[:] = [0, 0.0]
        stages: dict = {}
        out_dir = tempfile.mkdtemp(prefix="pg_profile_vo_")
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            segments, consumed = track_video_segments(
                source, settings, out_dir, device="cuda", stage_seconds=stages,
                patch_impl=patch_impl, **options)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        print(json.dumps({
            "configuration": name, "segments": segments, "frames": consumed,
            "seconds": seconds, "frames_per_s": consumed / seconds,
            "tracking_attempts": attempts[0],
            "attempt_host_ms": 1e3 * attempts[1] / max(attempts[0], 1),
            "chunks": stages["chunks"], "chunk_frames": stages["chunk_frames"],
            "refed": stages["refed"]}), flush=True)

    tracking.fused_track_step = counted_step
    try:
        run("frame by frame, features inline", frames(), feature_batch_size=0,
            make_tracker=per_frame)
        run("chunked with the prefetch threads (the default)", frames())
        camera, config = camera_and_config(settings, patch_impl=patch_impl)
        prefetched = list(prefetch_features(frames(), camera, config, device="cuda"))
        run("chunked, features prefetched before the run (no thread beside it)",
            iter(prefetched), feature_batch_size=0, make_tracker=chunked)
        run("frame by frame, features inline, again", frames(), feature_batch_size=0,
            make_tracker=per_frame)
    finally:
        tracking.fused_track_step = step


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ride", choices=["parallax", "loop"], default="parallax")
    parser.add_argument("--frames", type=int, default=None,
                        help="frames of the ride (default: all, 150 or 318)")
    parser.add_argument("--window", type=int, nargs=2, default=(60, 90),
                        help="frames [first, last) profiled by torch.profiler")
    parser.add_argument("--trace", default="", help="directory for the Chrome trace")
    parser.add_argument("--extract-only", action="store_true",
                        help="time the feature extractor alone, both patch paths")
    parser.add_argument("--loop-configurations", action="store_true",
                        help="the segment loop frame by frame, chunked with and without "
                        "the prefetch threads")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vo measures the card: no CUDA device")
    if args.extract_only:
        frames = 100 if args.frames is None else args.frames
        render = render_loop_ride if args.ride == "loop" else render_ride
        print(f"card: {card_name_and_power()}", flush=True)
        extract_only(list(render(frames)))
        return 0

    if args.ride == "loop":
        ride = list(render_loop_ride() if args.frames is None else render_loop_ride(args.frames))
        patch_impl = "fused"
    else:
        ride = list(render_ride() if args.frames is None else render_ride(args.frames))
        patch_impl = "blur_then_gather"
    if args.loop_configurations:
        print(f"card: {card_name_and_power()}", flush=True)
        loop_configurations(ride, patch_impl)
        return 0
    settings = ride_settings()
    totals = collections.defaultdict(lambda: [0.0, 0])
    originals = {name: getattr(tracking.MonocularTracker, name) for name in STEPS}
    for name, fn in originals.items():
        setattr(tracking.MonocularTracker, name, _timed(fn, name, totals))

    first, last = args.window
    # Device activity only: tracing every host op would slow the host,
    # which is what bounds this path.
    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    window = {}

    def frames():
        for i, gray in enumerate(ride):
            if i == first:
                torch.cuda.synchronize()
                profiler.start()
                window["start"] = time.perf_counter()
            if i == last:
                torch.cuda.synchronize()
                window["seconds"] = time.perf_counter() - window["start"]
                profiler.stop()
            yield VideoFrame(gray, i, int(round(i * 1e6 / 30.0)))

    stages: dict = {}
    out_dir = tempfile.mkdtemp(prefix="pg_profile_vo_")
    try:
        start = time.perf_counter()
        segments, consumed = track_video_segments(
            frames(), settings, out_dir, device="cuda", stage_seconds=stages,
            feature_batch_size=0, make_tracker=lambda: tracker_from_settings(
                settings, device="cuda", patch_impl=patch_impl, track_chunk_frames=0),
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        for name, fn in originals.items():
            setattr(tracking.MonocularTracker, name, fn)

    print(f"{segments} segment(s), {consumed} frames, {seconds:.2f} s "
          f"({consumed / seconds:.3f} frames/s, timed sections synchronise)")
    for stage in ("extract", "track"):
        print(f"stage {stage}: {1e3 * stages[stage] / consumed:.2f} ms/frame")
    for name, (value, calls) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        print(f"step {name}: {1e3 * value / consumed:.2f} ms/frame "
              f"({calls} calls, {1e3 * value / max(calls, 1):.2f} ms/call)")

    device = [e for e in profiler.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n = last - first
    busy_us = sum(e.device_time_total for e in device)
    kernels = sum(e.count for e in device if not e.key.startswith(("Memcpy", "Memset")))
    copies = sum(e.count for e in device if e.key.startswith("Memcpy"))
    wall = window["seconds"]
    print(f"profiled frames [{first}, {last}): wall {1e3 * wall / n:.2f} ms/frame, "
          f"device busy {busy_us / 1e3 / n:.2f} ms/frame "
          f"({100 * busy_us / 1e6 / wall:.1f}% busy, "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle); "
          f"{kernels / n:.0f} kernels and {copies / n:.0f} copies per frame")
    top = sorted(device, key=lambda e: -e.device_time_total)[:15]
    print(json.dumps([
        {"kernel": e.key[:80], "ms_per_frame": round(e.device_time_total / 1e3 / n, 4),
         "calls_per_frame": round(e.count / n, 1)}
        for e in top
    ], indent=1))
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.trace, "profile_vo_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
