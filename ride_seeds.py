"""The smoke's rides over several RANSAC generator seeds, on one NVIDIA card.

    python3 ride_seeds.py --ride loop|parallax|golden --seeds 0 1 2 3 4 [--loop-closing off]
        [--frames N] [--device cuda|cpu] [--dtype float32|float64] [--chunked]
        [--log PATH] [--swap NAME@cpu|NAME@float64|NAME@device ...] [--probe-svd]
        [--probe-solve] [--nudge N ...] [--features-to PATH | --features-from PATH]

Renders chip_smoke's parallax ride or loop ride at 1280x720, runs
optical_trajectories' segment loop frame by frame (as the smoke's phases 7
and 8; features extracted inline, track_chunk_frames=0), or with
``--chunked`` at the loop's defaults (feature prefetch, chunks of 16
through keyframes, as phase 7c and the CLI), on CUDA at 2000 features / 8
levels
(the parallax ride with blur-then-gather, the loop ride with the fused blur
+ patch gather, as chip_smoke runs them), once per seed of the tracker's
RANSAC generator, and prints one JSON line per run: segments, the frames of
the longest segment, loop closures, frames/s, and that segment's errors
against the ride's true poses (chip_smoke.trajectory_errors). The smoke's
loop-ride bars sit just above the worst reading of seeds 0 to 4. Unlike
the smoke, a run that loses track or misses a bar is reported, not raised.
``--ride golden`` runs the golden video (tests/golden/inputs, decoded by
video/io.py's routes) with its camera settings, as the VO CLI does, and
measures it against the golden trajectory (chip_smoke.trajectory_distance).
``--frames`` keeps the start of the ride only; ``--device cpu`` runs the
plain versions of the kernels on the CPU (a check of the tracker's
decisions, not a measurement), in float64 unless ``--dtype`` says
otherwise (the card runs float32): reference_seeds.py runs the JAX
package's tracker over the same frames.

``--log PATH`` appends, for every run, one JSON line per frame of the
first segment to PATH: the tracker's state, a digest of the frame's
features, each tracking attempt's projected matches, pose inliers and
pose (6 numbers), the pose kept, the keyframes, the first frame of the
chunk that consumed it (null frame by frame; a chunk's last attempt, on a
frame it stops at and leaves to the next, is logged with the state
NOT_CONSUMED), and at the two-view
initialization the model chosen (homography or essential) with its
inlier count. Logs of the same draws
on several devices and dtypes show the first frame where the runs part.

``--probe-svd`` measures every call of the port's SVD entry
(pilotguru_tpu_torch/utils/linalg.py::svd) of a run without changing it:
per calling function (and its caller), the worst error of its singular
values (relative to the largest) and of its last left and right singular
vectors (their angles, radians) against float64 on the CPU, for the
entry's result (``entry``), torch.linalg.svd on the input's device in its
dtype (``device``: the card's route before the entry), the CPU's LAPACK in
the input's dtype (``cpu``) and, on the card, cuSOLVER's QR-based float64
route rounded to the input's dtype (``gesvd64``). ``--probe-solve``
measures every torch.linalg.solve_ex call the same way: the worst error of
the solution, relative to its largest entry, as computed (``device``) and
from the CPU's LAPACK in the input's dtype (``cpu``).

``--swap`` reruns each seed with one stage of the tracker (``twoview``,
``track``, ``refkf``, ``create``, ``fuse``, ``ba``) or one operation
(``svd``: the port's SVD entry, ``solve``: torch.linalg.solve_ex) computed
on the CPU in the run's dtype (``@cpu``) or on the run's device in float64
(``@float64``), its results moved back. ``@device`` restores, on the
card in float32, a route that the package replaced there: ``svd@device``
computes each SVD with torch.linalg.svd in the input's dtype,
``solve@device`` local BA's solve with torch.linalg.solve_ex, and
``twoview@device`` the two-view reconstruction in float32 (the package
computes it in float64 on the card). ``none`` is the run as it stands; ``A+B`` puts
two swaps in force at once. The swaps live in this script: the package has
no such switch.

``--features-to PATH`` saves every frame's features as the run's trackers
were given them (kp_norm, desc, valid, kp_level, kp_angle, with the
frame's time; chip_smoke.save_features); ``--features-from PATH`` feeds
such a file's features to the run's trackers in the place of their own
extraction, on any device and dtype, frame by frame or ``--chunked``. The
RANSAC draws come from the tracker's CPU generator, so on the same
features a run on the CPU draws what a run on the card drew.

``--nudge N ...`` reruns each seed once per N with every keypoint
coordinate the tracker receives moved by one float32 ulp, up or down at
random (numpy generator N): whether a run keeps track across such nudges
tells a decision that sits on a rounding-level tie from a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import inspect
import itertools
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

import chip_smoke
from pilotguru_tpu_torch.formats.trajectory import read_trajectory
from pilotguru_tpu_torch.utils import linalg
from pilotguru_tpu_torch.vo import pipeline, tracking, twoview

STAGES = {
    "twoview": "two_view_reconstruction",
    "track": "fused_track_step",
    "refkf": "fused_ref_kf_track",
    "create": "create_points",
    "fuse": "fused_project_match",
    "ba": "bundle_adjust",
}
OPS = {"svd": (linalg, "svd"), "solve": (linalg, "solve_ex")}


def _moved(obj, device, dtype=None):
    """Tensors in ``obj`` (nested tuples / NamedTuples) on ``device``, the
    floating ones in ``dtype`` when given."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device=device, dtype=dtype if dtype and obj.is_floating_point() else None)
    if isinstance(obj, tuple):
        items = [_moved(o, device, dtype) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, list):
        return [_moved(o, device, dtype) for o in obj]
    return obj


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, tuple):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


def _swapped_fn(fn, where):
    """``fn`` computed on the CPU (``where == "cpu"``) or in float64 on its
    inputs' device, its outputs back on that device in the input dtype."""

    def wrapper(*args, **kwargs):
        ref = _first_tensor(args)
        if ref is None or (where == "cpu" and ref.device.type == "cpu"):
            return fn(*args, **kwargs)
        device, dtype = ref.device, ref.dtype
        if where == "cpu":
            out = fn(*_moved(args, "cpu"), **{k: _moved(v, "cpu") for k, v in kwargs.items()})
        else:
            out = fn(*_moved(args, device, torch.float64), **kwargs)
        return _moved(out, device, dtype if dtype.is_floating_point else None)

    return wrapper


def _device_svd(a, full_matrices=True):
    """torch.linalg.svd on ``a``'s device in its dtype (svd@device)."""
    return torch.linalg.svd(a, full_matrices=full_matrices)


def _device_solve_ex(a, b):
    """torch.linalg.solve_ex on ``a``'s device in its dtype (solve@device)."""
    return torch.linalg.solve_ex(a, b)


def _device_two_view(*args, **kwargs):
    """The two-view reconstruction on its inputs' device in their dtype
    (twoview@device)."""
    bound = inspect.signature(twoview.two_view_reconstruction).bind(*args, **kwargs)
    bound.apply_defaults()
    return twoview.reconstruct(*bound.args)


DEVICE_OPS = {"svd": _device_svd, "solve": _device_solve_ex, "twoview": _device_two_view}


@contextlib.contextmanager
def swapped(spec: str):
    """The swap ``spec`` ("none", "svd@cpu", "ba@float64", "svd@device",
    "svd@device+twoview@cpu", ...) in force."""
    if spec == "none":
        yield
        return
    if "+" in spec:
        with contextlib.ExitStack() as stack:
            for part in spec.split("+"):
                stack.enter_context(swapped(part))
            yield
        return
    name, where = spec.split("@")
    if where not in ("cpu", "float64") and not (where == "device" and name in DEVICE_OPS):
        raise ValueError(f"--swap {spec}: want NAME@cpu, NAME@float64, svd@device, "
                         "solve@device or twoview@device")
    if name in STAGES:
        owner, attr = tracking, STAGES[name]
    elif name in OPS:
        owner, attr = OPS[name]
    else:
        raise ValueError(f"--swap {spec}: unknown stage or operation {name}")
    original = getattr(owner, attr)
    setattr(owner, attr, DEVICE_OPS[name] if where == "device" else _swapped_fn(original, where))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def _angle(a, b):
    """Angles (radians, either sign) between the unit vectors along the
    last axis of ``a`` and ``b``, from their chord."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    chord = torch.minimum(torch.linalg.vector_norm(a - b, dim=-1),
                          torch.linalg.vector_norm(a + b, dim=-1))
    return 2.0 * torch.asin((chord / 2.0).clamp(max=1.0))


def _svd_errors(want, out):
    """(singular values, last left singular vector, last right singular
    vector) errors of one batched SVD result ``out`` against ``want``
    (float64 on the CPU): the largest |s - s64| / s64[0] and the largest
    angles between the last columns of u and the last rows of vt."""
    u64, s64, vt64 = want
    u, s, vt = (t.detach().to("cpu", torch.float64) for t in out)
    s_err = ((s - s64).abs() / s64[..., :1].clamp_min(1e-300)).max()
    u_rad = _angle(u[..., :, s64.shape[-1] - 1], u64[..., :, s64.shape[-1] - 1]).max()
    v_rad = _angle(vt[..., -1, :], vt64[..., -1, :]).max()
    return float(s_err), float(u_rad), float(v_rad)


def _caller(depth: int = 3, skip: int = 2):
    """"function < its caller < ..." of the probed call, ``depth`` deep,
    ``skip`` frames above this one."""
    f, names = sys._getframe(skip), []
    while f is not None and len(names) < depth:
        names.append(f.f_code.co_name)
        f = f.f_back
    return " < ".join(names)


def _keep_worst(stats, caller, errors: dict):
    row = stats.setdefault(caller, {"calls": 0})
    row["calls"] += 1
    for key, v in errors.items():
        row[key] = max(row.get(key, 0.0), v)


@contextlib.contextmanager
def probed_svd(stats: dict):
    """Every call of the SVD entry measured (not changed): per caller, the
    worst errors against float64 on the CPU of the entry's result and of
    the other routes on the same input (see --probe-svd)."""
    entry = linalg.svd

    def probe(a, full_matrices=True):
        out = entry(a, full_matrices=full_matrices)
        want = torch.linalg.svd(a.detach().to("cpu", torch.float64),
                                full_matrices=full_matrices)
        routes = {"entry": out,
                  "device": torch.linalg.svd(a.detach(), full_matrices=full_matrices),
                  "cpu": torch.linalg.svd(a.detach().cpu(), full_matrices=full_matrices)}
        if a.device.type == "cuda":
            routes["gesvd64"] = [t.to(a.dtype) for t in torch.linalg.svd(
                a.detach().to(torch.float64), full_matrices=full_matrices, driver="gesvd")]
        errors = {}
        for route, result in routes.items():
            for key, v in zip(("s_err", "u_rad", "v_rad"), _svd_errors(want, result)):
                errors[f"{route}_{key}"] = v
        _keep_worst(stats, _caller(), errors)
        return out

    linalg.svd = probe
    try:
        yield
    finally:
        linalg.svd = entry


@contextlib.contextmanager
def probed_solve(stats: dict):
    """Every linear solve measured (not changed): the calls of the port's
    solve entry and the torch.linalg.solve_ex calls outside it. Per
    caller, the worst error against float64 on the CPU, relative to the
    solution's largest entry, of the result, of torch.linalg.solve_ex on
    the input's device in its dtype, and of the CPU's in that dtype."""
    entry, solve_ex = linalg.solve_ex, torch.linalg.solve_ex
    inside = []

    def measure(a, b, result):
        a, b = a.detach(), b.detach()
        want = solve_ex(a.to("cpu", torch.float64), b.to("cpu", torch.float64))[0]
        scale = want.abs().max().clamp_min(1e-300)
        routes = {"result": result, "device": solve_ex(a, b)[0],
                  "cpu": solve_ex(a.cpu(), b.cpu())[0]}
        _keep_worst(stats, _caller(skip=3),
                    {f"{route}_err": float((x.detach().to("cpu", torch.float64) - want)
                                           .abs().max() / scale)
                     for route, x in routes.items()})

    def probe_entry(a, b):
        inside.append(True)
        try:
            out = entry(a, b)
        finally:
            inside.pop()
        measure(a, b, out[0])
        return out

    def probe_torch(a, b, *args, **kwargs):
        out = solve_ex(a, b, *args, **kwargs)
        if not inside:
            measure(a, b, out[0])
        return out

    linalg.solve_ex, torch.linalg.solve_ex = probe_entry, probe_torch
    try:
        yield
    finally:
        linalg.solve_ex, torch.linalg.solve_ex = entry, solve_ex


def _floats(values):
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().double().numpy()
    return [float(v) for v in np.asarray(values, np.float64).reshape(-1)]


def _digest(kp_norm, desc) -> str:
    """A short hash of a frame's keypoints and descriptors: equal digests
    on two devices mean the trackers were given the same features."""
    h = hashlib.sha1(np.ascontiguousarray(np.asarray(kp_norm, np.float32)).tobytes())
    h.update(np.ascontiguousarray(tracking.host_array(desc)).tobytes())
    return h.hexdigest()[:12]


def instrument(tracker, log: list):
    """Per-frame records of ``tracker`` appended to ``log`` (see --log)."""
    attempt = tracker._track_attempt
    process = tracker.process_features
    chunk = tracker.process_chunk
    commit = tracker._commit_tracked_frame
    pending = []  # attempts not yet given to a frame's record
    where = {"chunk": None, "process": 0}

    def record(frame_id, kp_norm, desc, chunk_start):
        rec = {"frame": int(frame_id), "chunk": chunk_start,
               "features": _digest(kp_norm, desc), "attempts": list(pending), "init": []}
        pending.clear()
        return rec

    def close(rec, state):
        rec.update(state=state, pose6=_floats(tracker._pose),
                   keyframes=[kf.kf_id for kf in tracker.keyframes],
                   map_points=int(tracker.point_valid.sum()))

    def logged_attempt(*args):
        out = attempt(*args)
        pose6, inliers, match_idx = out[0], out[1], out[2]
        pending.append({"matches": int((match_idx >= 0).sum()), "inliers": int(inliers),
                        "pose6": _floats(pose6)})
        return out

    def logged_process(kp_norm, desc, valid, frame_id, time_usec, kp_level, kp_angle):
        pending.clear()
        rec = record(frame_id, kp_norm, desc, where["chunk"])
        log.append(rec)
        where["process"] += 1
        try:
            state = process(kp_norm, desc, valid, frame_id, time_usec, kp_level, kp_angle)
        finally:
            where["process"] -= 1
        rec["attempts"] = list(pending)
        pending.clear()
        close(rec, state)
        return state

    def logged_chunk(frames):
        pending.clear()
        where["chunk"] = int(frames[0].frame_id) if frames else None
        try:
            results = chunk(frames)
            if pending:  # the attempt of the frame where the chunk stopped
                f = frames[len(results)]
                rec = record(f.frame_id, f.features[0], f.features[1], where["chunk"])
                close(rec, "NOT_CONSUMED")
                log.append(rec)
            return results
        finally:
            where["chunk"] = None
            pending.clear()

    def logged_commit(frame, frame_id, time_usec, *rest):
        commit(frame, frame_id, time_usec, *rest)
        if where["chunk"] is not None and where["process"] == 0:
            rec = record(frame_id, frame.kp_norm, frame.desc, where["chunk"])
            close(rec, tracking.OK)
            log.append(rec)

    tracker._track_attempt = logged_attempt
    tracker.process_features = logged_process
    tracker.process_chunk = logged_chunk
    tracker._commit_tracked_frame = logged_commit


@contextlib.contextmanager
def logged_two_view(log: list):
    """Record each two-view initialization's chosen model (the one of the
    homography's and the essential matrix's poses nearer its result) and
    inliers."""
    solve = tracking.two_view_reconstruction
    recover = {"E": twoview.recover_pose, "H": twoview.recover_pose_homography}
    seen = {}

    def recording(model):
        def wrapped(*args):
            out = recover[model](*args)
            seen[model] = out[0].detach().cpu().double()
            return out
        return wrapped

    def recording_solve(p1, p2, mask, *args, **kwargs):
        res = solve(p1, p2, mask, *args, **kwargs)
        rotation = res.rotation.detach().cpu().double()
        model = min(seen, key=lambda m: float((seen[m] - rotation).abs().max()))
        if log and "state" not in log[-1]:  # the logged tracker's own frame
            log[-1]["init"].append({"matches": int(mask.sum()), "model": model,
                                    "inliers": int(res.score),
                                    "rotation": _floats(res.rotation),
                                    "translation": _floats(res.translation)})
        return res

    tracking.two_view_reconstruction = recording_solve
    twoview.recover_pose = recording("E")
    twoview.recover_pose_homography = recording("H")
    try:
        yield
    finally:
        tracking.two_view_reconstruction = solve
        twoview.recover_pose = recover["E"]
        twoview.recover_pose_homography = recover["H"]


def nudge_features(tracker, nudge_seed: int):
    """Move every keypoint coordinate the tracker receives by one float32
    ulp, up or down at random (numpy generator ``nudge_seed``): an input
    change at the rounding level of the extractor's output."""
    features = tracker.features
    rng = np.random.default_rng(nudge_seed)

    def nudged(gray):
        kp_norm, *rest = features(gray)
        away = np.where(rng.random(kp_norm.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        return (np.nextafter(kp_norm, away), *rest)

    tracker._feature_fn = nudged


def run_seed(ride, seed, loop_closing, device="cuda", dtype=None, frame_log=None, nudge=None,
             chunked=False, features_to=None, features_from=None):
    """One run over ``ride`` (load_ride's); returns its JSON row.
    ``features_to``: a dict that takes every frame's features
    (chip_smoke.record_features); ``features_from``: such a dict, whose
    features the trackers are fed in the place of their own extraction."""
    trackers = []
    make = pipeline.tracker_from_settings
    chunk_frames = pipeline.TrackerConfig.track_chunk_frames if chunked else 0

    def seeded_tracker_from_settings(*args, **kwargs):
        tracker = make(*args, **kwargs)
        tracker.config = dataclasses.replace(tracker.config,
                                             enable_loop_closing=loop_closing,
                                             track_chunk_frames=chunk_frames)
        tracker._generator.manual_seed(seed)
        if nudge is not None:
            nudge_features(tracker, nudge + len(trackers))
        if frame_log is not None and not trackers:
            instrument(tracker, frame_log)
        if features_to is not None:
            chip_smoke.record_features(tracker, features_to)
        trackers.append(tracker)
        return tracker

    out_dir = tempfile.mkdtemp(prefix="pg_ride_seeds_")
    pipeline.tracker_from_settings = seeded_tracker_from_settings
    try:
        with logged_two_view(frame_log if frame_log is not None else []):
            start = time.perf_counter()
            stages: dict = {}
            if features_from is not None:
                frames = chip_smoke.replayed_frames(features_from)
            else:
                frames = (pipeline.VideoFrame(g, i, t) for i, (g, t) in enumerate(ride.frames))
            segments, consumed = pipeline.track_video_segments(
                frames, ride.settings, out_dir, device=device, dtype=dtype,
                patch_impl=ride.patch_impl, stage_seconds=stages,
                **({} if chunked and features_from is None else {"feature_batch_size": 0}),
            )
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        trajs = [read_trajectory(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))]
    finally:
        pipeline.tracker_from_settings = make
        shutil.rmtree(out_dir, ignore_errors=True)
    row = {"seed": seed, "nudge": nudge, "loop_closing": loop_closing, "chunked": chunked,
           "replayed_features": features_from is not None, "device": device,
           "dtype": str(trackers[0].dtype), "segments": segments, "frames": consumed,
           "frames_per_s": consumed / seconds,
           "loop_closures": [t.stats["loop_closures"] for t in trackers],
           "keyframes": [len(t.keyframes) for t in trackers]}
    if chunked:
        row.update(chunks=stages["chunks"], chunk_frames=stages["chunk_frames"],
                   refed=stages["refed"])
    if trajs:
        longest = max(trajs, key=len)
        row["longest_segment"] = [int(longest.frame_id[0]), int(longest.frame_id[-1])]
        row["errors"] = ride.errors(longest)
    return row


def load_ride(name: str, frames=None) -> SimpleNamespace:
    """The ride ``name`` (its first ``frames`` frames; the golden video
    whole): (gray, time_usec)
    pairs, camera settings, patch path, and its trajectory errors (against
    the true poses; the golden video's against the golden trajectory, as
    chip_smoke's golden phase measures it)."""
    if name == "golden":
        from pilotguru_tpu_torch.vo.camera import read_camera_settings

        golden = read_trajectory(chip_smoke.GOLDEN_TRAJECTORY)
        return SimpleNamespace(
            frames=[(f.gray, f.time_usec)
                    for f in pipeline.video_frames(chip_smoke.GOLDEN_VIDEO)],
            settings=read_camera_settings(chip_smoke.GOLDEN_CAMERA),
            patch_impl="blur_then_gather",
            errors=lambda traj: chip_smoke.trajectory_distance(traj, golden))
    sized = {} if frames is None else {"frames": frames}
    if name == "loop":
        grays = chip_smoke.render_loop_ride(**sized)
        patch_impl, pose_of, period = "fused", chip_smoke.loop_pose, chip_smoke.LOOP_PERIOD
    else:
        grays = chip_smoke.render_ride(**sized)
        patch_impl, pose_of, period = "blur_then_gather", chip_smoke.ride_pose, None
    return SimpleNamespace(
        frames=[(g, int(round(i * 1e6 / 30.0))) for i, g in enumerate(grays)],
        settings=chip_smoke.ride_settings(), patch_impl=patch_impl,
        errors=lambda traj: chip_smoke.trajectory_errors(traj, pose_of, period))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ride", choices=["parallax", "loop", "golden"], default="loop")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--loop-closing", choices=["on", "off"], default="on")
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--dtype", choices=["float32", "float64"], default=None)
    parser.add_argument("--log", default=None, help="append per-frame JSON lines here")
    parser.add_argument("--swap", nargs="+", default=["none"])
    parser.add_argument("--nudge", type=int, nargs="+", default=None,
                        help="rerun each seed with the keypoints moved by one float32 ulp "
                        "(one run per nudge seed)")
    parser.add_argument("--probe-svd", action="store_true",
                        help="print each SVD call site's errors against float64")
    parser.add_argument("--probe-solve", action="store_true",
                        help="print each solve_ex call site's errors against float64")
    features = parser.add_mutually_exclusive_group()
    features.add_argument("--features-to", default=None,
                          help="save every frame's features here (npz)")
    features.add_argument("--features-from", default=None,
                          help="feed the trackers the features saved here")
    parser.add_argument("--chunked", action="store_true",
                        help="the segment loop at its defaults: feature prefetch, chunks of 16 "
                        "through keyframes")
    args = parser.parse_args(argv)
    if args.ride == "golden" and args.frames is not None:
        parser.error("--frames cuts a rendered ride; the golden video runs whole")
    if args.nudge and (args.chunked or args.features_from):
        parser.error("--nudge moves the tracker's own extraction; not with --chunked or "
                     "--features-from")
    if args.features_to and len(args.seeds) * len(args.swap) > 1:
        parser.error("--features-to saves one run's features: give one seed and one swap")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("ride_seeds measures the card: no CUDA device")
        print(f"card: {chip_smoke.card_name_and_power()}", flush=True)
    ride = load_ride(args.ride, args.frames)
    features_from = chip_smoke.load_features(args.features_from) if args.features_from else None
    for spec, seed, nudge in itertools.product(args.swap, args.seeds, args.nudge or [None]):
        frame_log = [] if args.log else None
        svd_stats, solve_stats = {}, {}
        features_to = {} if args.features_to else None
        with contextlib.ExitStack() as stack:
            stack.enter_context(swapped(spec))
            if args.probe_svd:
                stack.enter_context(probed_svd(svd_stats))
            if args.probe_solve:
                stack.enter_context(probed_solve(solve_stats))
            row = run_seed(ride, seed, args.loop_closing == "on", args.device,
                           args.dtype and getattr(torch, args.dtype), frame_log, nudge,
                           args.chunked, features_to, features_from)
        if features_to is not None:
            chip_smoke.save_features(args.features_to, features_to)
        head = {"ride": args.ride, "swap": spec}
        print(json.dumps({**head, **row}), flush=True)
        if args.probe_svd:
            print(json.dumps({**head, "seed": seed, "svd_errors": svd_stats}), flush=True)
        if args.probe_solve:
            print(json.dumps({**head, "seed": seed, "solve_errors": solve_stats}), flush=True)
        if args.log:
            with open(args.log, "a") as f:
                for rec in frame_log:
                    f.write(json.dumps({**head, "seed": seed, "nudge": nudge,
                                        "device": row["device"], "dtype": row["dtype"],
                                        **rec}) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
