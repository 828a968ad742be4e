"""Traffic driver ``vo_ride``: one rendered ride through the VO CLI's
default path, ``pilotguru_tpu_torch.vo.pipeline.track_video_segments``
(decode thread, features prefetched in batches on a worker thread, chunks
of frames tracked through keyframes, loop closing on).

Set-up renders the ride from the seed on the device and tracks its first
``warmup_frames`` through the same path (initialization, chunks, keyframes,
local BA). The window is one job of a fixed size: the first
``ceil(seconds * nominal_fps)`` frames of the ride (again from its start
where the ride is shorter) through a fresh segment loop, from the first
frame read to the trajectory written. ``nominal_fps`` (the traffic file's)
makes the window last about the run's seconds today; both sides of a
comparison track the same frames. Frames per second are all the frames
over all the window's time.

The harness wraps the tracker's entry points (a subclass that only counts
frames and records each call's host span). A traced run profiles the whole
window, the profiler opened before its first frame and read after the
trajectory is written. Nothing here changes what the program computes.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from gpubench.devtrace import DeviceTrace, Spans
from gpubench.reference import orb, plain_float32, ride


class Probe:
    """What the harness sees at the tracker's boundary: frames done and
    lost, and a host span for each call."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.done = self.lost = self.depth = 0
        self.spans = Spans()

    def call(self, fn, lost_of):
        outer = self.depth == 0
        start_ns = time.time_ns()
        self.depth += 1
        try:
            result = fn()
        finally:
            self.depth -= 1
        if outer:
            n, lost = lost_of(result)
            self.done += n
            self.lost += lost
            self.spans.add("tracker call", start_ns, time.time_ns())
        return result


def tracker_class(probe: Probe):
    from pilotguru_tpu_torch.vo.tracking import LOST, MonocularTracker

    class BenchTracker(MonocularTracker):
        def process_chunk(self, frames):
            return probe.call(lambda: super(BenchTracker, self).process_chunk(frames),
                              lambda res: (len(res), sum(s == LOST for s, _ in res)))

        def process_features(self, *args, **kwargs):
            return probe.call(lambda: super(BenchTracker, self).process_features(*args, **kwargs),
                              lambda state: (1, int(state == LOST)))

    return BenchTracker


def frame_source(grays: np.ndarray, fps: float, count: int, yielded: list):
    """``count`` VideoFrames of the ride, again from its start once it runs
    out; each fresh (the prefetcher attaches features to it)."""
    from pilotguru_tpu_torch.vo.pipeline import VideoFrame

    for fid in range(count):
        frame = VideoFrame(grays[fid % len(grays)], fid, int(round(fid * 1e6 / fps)))
        yielded.append(frame)
        yield frame


def check_extractor(frames, grays, cfg, device, count: int, seed: int,
                    bfloat16_control: bool = False):
    """The window's extracted features of ``count`` frames drawn from the
    seed against the plain extractor's; and the per-frame work quantities
    of those frames' keypoints. With ``bfloat16_control`` the plain
    extractor computed in bfloat16 takes the program's place."""
    import torch

    from gpubench import workmodel

    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(frames), size=min(count, len(frames)), replace=False))
    totals = {"keypoint_mismatches": 0, "descriptor_bit_mismatches": 0}
    covered = []
    for i in picks:
        frame = frames[i]
        gray = torch.as_tensor(grays[frame.frame_id % len(grays)], device=device)
        ref = orb.extract(gray, cfg)
        if bfloat16_control:
            low = orb.extract(gray, cfg, dtype=torch.bfloat16)
            kp_norm = (low.xy.double().cpu().numpy() - [cfg["cx"], cfg["cy"]]) / [cfg["fx"],
                                                                                   cfg["fy"]]
            desc, valid, level = low.descriptors, low.valid.cpu(), low.level.cpu()
        else:
            kp_norm, desc, valid, level, _ = frame.features
        desc = desc.cpu().numpy() if isinstance(desc, torch.Tensor) else np.asarray(desc)
        got = orb.compare({"kp_norm": kp_norm, "desc": desc, "valid": valid, "level": level},
                          ref, cfg)
        for key in totals:
            totals[key] += got[key]
        levels = ref.level.cpu().numpy()
        yx = ref.yx.cpu().numpy()
        covered.append(workmodel.extractor_quantities(
            cfg, [yx[levels == lv] for lv in range(cfg["orb_levels"])])["patch_covered_pixels"])
    quantities = workmodel.extractor_quantities(cfg)
    quantities["patch_covered_pixels"] = float(np.mean(covered)) if covered else None
    return totals, quantities, [frames[i].frame_id for i in picks]


def run(r):
    import torch

    from gpubench.harness import Check, Outcome
    from pilotguru_tpu_torch.vo import pipeline
    from pilotguru_tpu_torch.vo.camera import CameraSettings

    cfg, trf, cell = r.config, r.traffic, r.cell
    device = torch.device(r.device)
    grays = ride.render_ride(trf, cfg, device, r.seed)
    settings = CameraSettings(fx=cfg["fx"], fy=cfg["fy"], cx=cfg["cx"], cy=cfg["cy"],
                              orb_features=cfg["orb_features"], orb_scale=cfg["orb_scale"],
                              orb_levels=cfg["orb_levels"],
                              orb_ini_th_fast=cfg["fast_threshold"])
    camera, tconfig = pipeline.camera_and_config(settings, 1.0, cfg["patch_impl"],
                                                 cfg["track_chunk_frames"])
    dtype = getattr(torch, cfg["dtype"])
    probe = Probe()
    tracker_cls = tracker_class(probe)

    def make_tracker():
        return tracker_cls(camera, tconfig, device=device, dtype=dtype)

    def track(frames, out_dir, stages=None):
        return pipeline.track_video_segments(
            frames, settings, out_dir, make_tracker=make_tracker,
            feature_batch_size=cfg["feature_batch_size"], device=device, dtype=dtype,
            stage_seconds=stages, patch_impl=cfg["patch_impl"])

    warm = []
    track(frame_source(grays, trf["fps"], trf["warmup_frames"], warm),
          os.path.join(r.out_root, "warmup"))
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    probe.reset()
    trace = DeviceTrace() if r.trace else None

    yielded: list = []
    stages: dict = {}
    out_dir = os.path.join(r.out_root, "window")
    count = math.ceil(r.seconds * trf["nominal_fps"])
    if trace is not None:
        trace.start()
    t0 = time.perf_counter()
    setup_s = time.time() - r.t_start
    segments, consumed = track(frame_source(grays, trf["fps"], count, yielded), out_dir,
                               stages)
    seconds = time.perf_counter() - t0
    if trace is not None:
        trace.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = trace.summary(probe.spans, "segment loop outside the tracker") if trace else None

    # The check: once the window has closed and the peak is read.
    with plain_float32():
        totals, quantities, picked = check_extractor(yielded, grays, cfg, device,
                                                     cell["check_frames"], r.seed,
                                                     r.precision == "bfloat16")
    del yielded
    path = os.path.join(out_dir, "trajectory-0000.json")
    errors = (ride.trajectory_errors(ride.read_trajectory(path), trf) if os.path.exists(path)
              else {key: float("inf") for key in ("rotation_max_deg", "rotation_mean_deg",
                                                 "centre_rmse_of_path", "normal_deg")})
    limits = cell["limits"]
    checks = [Check(name, float(value), limits[name]) for name, value in totals.items()]
    checks += [Check(name, value, limits[name]) for name, value in errors.items()]
    checks.append(Check("lost_frames", float(probe.lost), limits["lost_frames"]))
    layer = {"vo": {"stage_seconds": stages, "consumed": consumed, "trace": summary,
                    "quantities": quantities}}
    return Outcome(
        attempted=consumed, failed=probe.lost,
        end_to_end={"vo_frames_per_s": (consumed / seconds, "frames/s"),
                    "setup_s": (setup_s, "s")},
        layer=layer, checks=checks, memory_peak_bytes=peak, trace=summary,
        notes={"window_frames": consumed, "window_s": seconds, "segments": segments,
               "checked_frames": picked})
