"""Where the VO main path spends its time on the card.

    python3 profile_vo.py [--ride parallax|loop] [--frames N] [--trace DIR]
    python3 profile_vo.py --extract-only [--ride parallax|loop] [--frames N]

Runs one of chip_smoke's synthetic 720p rides (2000 features, 8 levels):
the parallax ride (render_ride, blur-then-gather) or the loop ride
(render_loop_ride, the fused blur + gather, one loop closed near its end)
through the port's segment loop on CUDA and prints, per frame:
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
from pilotguru_tpu_torch.vo.pipeline import VideoFrame, track_video_segments

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
            patch_impl=patch_impl,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        for name, fn in originals.items():
            setattr(tracking.MonocularTracker, name, fn)

    print(f"{segments} segment(s), {consumed} frames, {seconds:.2f} s "
          f"({consumed / seconds:.3f} frames/s, timed sections synchronise)")
    for stage, value in stages.items():
        print(f"stage {stage}: {1e3 * value / consumed:.2f} ms/frame")
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
