"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. print the card's name and power limit (nvidia-smi) and check that TF32
     is off;
  2. build the CUDA kernels from pilotguru_tpu_torch/csrc with nvcc (one
     process per source, all at once);
  3. K1 (FAST + NMS) against its plain PyTorch version at the 8 pyramid
     level sizes of a 720p frame and at 1080p, and its all-level call (one
     launch over the 8 levels) against 8 plain calls;
  4. K2 (patch gather) against its plain version on a 720p image, and its
     all-level call (one launch, the extractor's per-level budgets plus
     border and corner keypoints) against 8 plain calls;
  5. K3 (fused blur + patch gather) against its plain version at the 8
     level sizes (random, near-border and corner keypoints), and its
     all-level call (one launch, the extractor's per-level budgets plus
     border and corner keypoints) against 8 plain calls;
  5b. the fused batch norm + ReLU pair (csrc/bn_relu.cuh) forward and
     backward against its plain version over the train-mode batch norms of
     a folded PilotNet x3 step at batch 1,024, in float32 and bfloat16,
     within BN_BARS;
  5c. the folded convolutions' backward pair (csrc/conv_bwd.cuh, dgrad and
     wgrad) against its plain version at every conv of a folded PilotNet
     x3 and x12 step and a Rambo x3 step at batch 1,024, within CONV_BAR of
     each gradient's norm, and two calls equal to the bit;
  6. the extractor on CUDA against the CPU, with both patch paths, and the
     seed guard (run_seed_guard): the first 20 parallax frames on the card
     in float32 at RANSAC seed 2 through process_frame, reporting the frame
     where track is lost beside the recorded one and, once the lanes are
     done, beside the CPU's float32 run's (a child process beside the
     lanes; a float32 tie, PERF.md);
  7. the parallax path: optical_trajectories' segment loop
     (pilotguru_tpu_torch.vo.pipeline.track_video_segments) with the default
     tracker configuration (loop closing on, blur-then-gather) but frame by
     frame (features extracted inline, track_chunk_frames=0) on a 150-frame
     1280x720 synthetic ride at 2000 features / 8 levels; every frame in one
     segment, no loop closed (the ride never revisits a place), K1 and K2
     launched once a frame each, K3 never, and the trajectory within
     TRUTH_BARS of the ride's true poses;
  8. the loop ride: the same segment loop, frame by frame, with
     PGTPU_PATCH_IMPL=fused's configuration on a 318-frame closed-circuit
     1280x720 ride whose last
     30 frames revisit its start; every frame in one segment, at least one
     loop closed, K1 and K3 launched once a frame each, K2 never, and the
     trajectory within LOOP_TRUTH_BARS, the end-to-start closure error
     among them;
 7c. both rides through the segment loop at its defaults, the CLI's
     configuration (run_default_parallax, run_default_loop): frames decoded
     on a thread, features prefetched in batches of 8 on a worker thread,
     chunks of 16 tracked through keyframes; phases 7's and 8's checks and
     bars, in float32 as the CLI runs on the card; frames/s beside phases
     7 and 8, chunks, frames consumed a chunk,
     frames re-fed, the wait for prefetched features, peak memory, and the
     parallax ride's device idle share over the chunks from frame 60 to 68
     (torch.profiler, whose window is left out of the frames/s);
  9. the optical_trajectories CLI (its main, with its flags, at its
     defaults) over the parallax ride written as a gray PNG image list with
     rgb.txt and a settings YAML written by vo/camera.py, in a child process
     where cv2 cannot be imported (run_vo_cli_image_list): the trajectory
     equal to phase 7c's parallax trajectory to the byte, K1 and K2 once a
     frame, frames/s beside phase 7c's;
 9b. the tracker's image entry (run_process_frame): the first 40 parallax
     frames through MonocularTracker.process_frame with feature_fn=None, K1
     and K2 once a frame, no plain call, every state and pose equal to the
     bit to a process_features run over the same frames at the same seed;
 10. the CLI on the golden mp4 (run_golden_cli), when video/io.py finds a
     decoder on this machine (mp4_decoder): at its defaults, chunked, within
     SLICE_BARS of the golden trajectory and of the port's CPU tracker
     replaying the card run's features chunked in float32 (the same
     features and RANSAC draws: check_golden_replay); frame by frame within
     SLICE_BARS of the golden and of the port's CPU run frame by frame on
     the same frames;
 11. make_steering_dataset on a 600-frame 640x360 road ride (render_road,
     an RGB PNG image list, tests/synthetic.py-shaped JSONs) to 66x200 YUV,
     on the card and on the CPU: every npz array and PNG equal; seconds
     and examples/s;
 12. predict_video with a 3-net PilotNet ensemble at 66x200x3 (weights from
     a numpy seed, written as flax msgpack by the port's codec) over the
     same frames on the card in float32 and bfloat16 and on the CPU in
     float32: float32 within PREDICT_F32_BAR on every frame, bfloat16
     within PREDICT_BF16_BAR; the CLI's frames/s, the forward pass alone at
     batch 1 and 1,024 (ms, examples/s, peak memory) and the device's idle
     share over the CLI (torch.profiler);
 12a. the train CLI on that dataset (TRAIN: PilotNet x3, SGD, batch 64, 3
     epochs, --batch_use_prob=0.7, exp_recent_loss) on the card in float32
     and bfloat16 and on the CPU in float32 (check_training): the card's
     float32 per-epoch per-net losses and last checkpoints within
     TRAIN_F32_BARS of the CPU's (this training amplifies rounding; the
     first step alone within TRAIN_STEP_BARS); a second float32 run on the
     card equal to the first to the bit; bfloat16 finite, falling and
     within TRAIN_BF16_BAR of float32;
 12b. predict_video over the road ride with the checkpoints the card's
     float32 run wrote (dataset -> train -> predict on the card): finite,
     not constant, its correlation with the road's yaw rate reported;
 12c. hyperparams_search (run_search): three folds, two sharing a program
     and differing in learning rate, one epoch on the card, each fold's log
     and checkpoints in its own directories. The CPU references of phases
     10 to 12a run in one child process beside the card's runs;
 12d. the train step's throughput (train_throughput): the folded PilotNet
     x3 step with augmentation on, on synthetic 66x220 frames at batch 128
     to 4,096 in float32 and bfloat16 (ms, examples/s, peak memory, device
     operations a step), and the device's idle share over one train_models
     epoch;
 12e. predict_live (run_predict_live) on the card over the road ride's PNG
     list with phase 12's checkpoints in float32, a ZMQ SUB thread on
     ipc://: the received {"s": degrees} an in-order subsequence of phase
     12's float32 predict_video steering x 90 within PREDICT_F32_BAR;
     frames/s, messages received, host ms a frame from read to send;
 12f. the saliency gradient of render_input_pixel_importance (run_saliency)
     on the card against the CPU on 64 road frames at batch 8, float32,
     within SALIENCY's bars (the difference's RMS, the share of pixels
     off); then the CLI over the ride: seconds, frames/s, peak device
     memory, frames written;
 12g. the BA oracle, bundle_adjust(solver="dense") (run_dense_ba), on the
     card in float64 on the local BA of phase 7's last keyframe, against the
     Schur path within DENSE_BA_BARS with equal inlier masks; the dense
     Jacobian's size reckoned first, each solve's ms, the dense solve's
     peak device memory;
 12h. map checkpoints (run_map_resume): phase 7's tracker saved after frame
     MAP_SAVE_FRAME (vo/map_io.py; the save leaves phase 7 as it is and
     its time is taken off phase 7's),
     loaded into a fresh tracker on the card that tracks the rest of the
     ride: every frame OK, K1 and K2 once a frame, the joined trajectory
     within TRUTH_BARS, and whether it equals phase 7's;
 12i. the VO CLI on the golden mp4 with --visualize and
     --visualize_live_port=0 (run_visualize, where a decoder exists): the
     trajectory equal to phase 10's to the byte, an overlay video of every
     frame, /state.json, / and one JPEG fetched while the ride tracks, K1
     and K2 once a frame; then --output_per_segment_videos on it: the
     segment video holds the OK frames, the JSON's ids index it and its
     poses are phase 10's from the first OK frame on;
 12j. render_frame_numbers, render_motion and calibrate on the card's
     machine (run_host_tools; host only, no kernel runs): frames and shapes
     written, calibrate on board.mp4 within CALIBRATE_BAR of the golden
     YAML;
 13. fit_motion's path (run_fit_motion): fit_motion_arrays on a 300 s and
     a 1,800 s IMU + GPS ride in float32 and float64, timed (ride-s/s,
     per-stage ms, peak device memory), each within the velocity RMSE bar
     of the ride's true speed, and the card's float64 against the port's
     float64 on the CPU, with each stage's output (fit_motion_stages) on
     the rides with hills;
 14. the corpus path (run_corpus): fit_motion_corpus on bench.py's corpus
     (8 rides of 300 s, each with its own noise seed) in float32 and
     float64, timed (ride-s/s, peak device memory), each ride within the
     RMSE bar and equal, bit for bit, to its own fit_motion_arrays result;
     then the preprocess_corpus CLI over the rides written as ride
     directories, timed with its JSON;
 15. the ride-annotation path (run_annotation): on a 1,800 s ride with
     54,000 frame times at 30 fps and a Kia CAN log, preprocess_all,
     interpolate_velocity, integrate_motion, annotate_frames (speeds, and
     steering smoothed), smooth_heading_directions and project_translations
     (on the parallax path's trajectory and a 54,000-frame one), each
     timed, the interpolated speeds within INTERPOLATION_BARS; then the same CLIs
     on a 300 s ride with hills on the card in float32 and float64 and on
     the CPU in float64: the card's float outputs within ANNOTATION_BARS of
     the CPU's (integrate_motion's float32 within 0.0063 m/s), the
     host-only outputs identical;
 15b. the sharded paths (run_sharded_paths), over every visible card, or
     over cuda:0 twice where only one is visible (sharded_devices): the
     card's name and power limit and the cards visible; (a) phase 14's
     corpus over a ("windows",) mesh in float32 and float64 against phase
     14's unsharded results: the vertical axis, steering and event times
     equal to the bit, the speeds and forward axis within FIT_LEVEL_BARS
     (three operations of the windows' solve change their bits with the
     windows in a call; SHARDED_CORPUS_EXACT's comment); (b)
     the parallax ride's 150 frames prefetched over the devices, every
     feature equal to the bit to the one-device prefetcher's, K1 and K2
     150 launches each (counts set to 0 just before the sharded run); (c)
     a hyperparams_search group of two PilotNet folds split one net a
     device against the same group on one device, within
     SHARDED_SEARCH_BARS; (d) the fit_motion CLI with
     PILOTGURU_TPU_PROFILE_DIR set, a trace holding the card's kernels and
     the files of the run without it;
 16. the kernels' times, one level at a time and all levels in one launch,
     each beside its bound, and beside K1 two floors: an empty kernel on
     its grid and a copy of its bytes; the fused batch norm pair over a
     PilotNet x3 and x12 step's layers beside its bound, the plain version
     and the op-by-op expression it replaced; the conv backward pair at
     each conv of the three training cells' steps beside its FLOP bound,
     the plain version and cuDNN's deterministic backward (the yardstick,
     which the port's float32 training does not call): slower than cuDNN at
     any layer fails the smoke;
 17. one JSON line with every kernel at the shape the paths give it (all 8
     levels of a 720p frame in one launch): launches
     on the paths (phases 7, 8, 7c, 9, 9b, 12h, 12i and 15b), error against the plain version,
     device ms, plain ms, the card's bound, a library call's ms where one
     exists; then, last, one JSON object
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Order: phases 1 to 6, phase 7 and 7c's parallax ride have the card
alone (their frames/s are the pair compared). Then five lanes, each a
spawned process (Lane), run beside the main process: phase 8; 7c's loop
ride; phases 9 and 9b and phase 10's frame-by-frame golden run; phase 10's
golden run at the CLI's defaults, its CPU replay (a child process) and
12i; phases 13 to 15b. Phase 10's frame-by-frame CPU run is a child
process beside them, and the main process runs phases 11 to 12c
and 12e to 12h and 12j. Every lane's result is awaited (a lane that
raised fails the smoke), then 12d, the forward-pass timings of phase 12
and phase 16 run alone. The times printed inside the lanes and beside them
share the host and the card.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero
without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

LEVEL_SHAPES_720P = [
    (720, 1280), (600, 1067), (500, 889), (417, 741),
    (347, 617), (289, 514), (241, 429), (201, 357),
]
# pyramid_level_budgets(2000, 8, 1.2): the extractor's keypoints per level.
LEVEL_BUDGETS_2000 = [434, 362, 302, 251, 209, 175, 145, 122]
RIDE_FRAMES = 150
RIDE_W, RIDE_H = 1280, 720
RIDE_FX = 700.0
RIDE_PERIOD = 60.0
RIDE_SPEED = 0.015

# The loop ride: a circle of radius LOOP_RADIUS, LOOP_PERIOD frames a turn,
# LOOP_FRAMES frames in all, so frames LOOP_PERIOD.. revisit frames 0..
LOOP_RADIUS = 3.0
LOOP_PERIOD = 288
LOOP_FRAMES = 318

# The H100's published peaks (NVIDIA's data sheet, SXM, 700 W): device
# memory bandwidth and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# Bars of the parallax path against the ride's true poses, besides every
# frame tracked in one segment: the worst and the mean per-frame rotation
# error (degrees), the camera-centre RMSE after a Sim(3) alignment (fraction
# of the true path length) and the plane normal's error (degrees). They were
# set just above the worst of RANSAC generator seeds 0 to 4 on an H100
# (PERF.md). Read again with loop closing on (ride_seeds.py; the rides now
# repeat bit for bit): seed 0, this run's, reads 1.534, 0.219, 0.0079 and
# 0.067, and seeds 1, 3 and 4 stay within the bars; seed 2 loses track at
# frame 12, and its 137-frame segment reads 2.403 and 0.393 degrees, over
# them (an open question in PERF.md, not a reason to loosen them).
TRUTH_BARS = {"rotation_max_deg": 2.0, "rotation_mean_deg": 0.33,
              "centre_rmse_of_path": 0.025, "normal_deg": 0.5}
# The loop ride's bars, the same readings plus the closure error: the mean
# distance between the aligned centres of frames i and i + LOOP_PERIOD (the
# same true place), as a fraction of the path length. Just above the worst
# reading of seeds 0 to 4 on an H100 (ride_seeds.py, PERF.md), all from
# seed 0, this run's: 0.770, 0.0823, 0.00144, 0.0021 and 0.0034. With loop
# closing off, seed 0 reads 0.763, 0.157, 0.00213, 0.0019 and 0.0067: the
# mean rotation, centre and closure bars fail it.
LOOP_TRUTH_BARS = {"rotation_max_deg": 0.9, "rotation_mean_deg": 0.1,
                   "centre_rmse_of_path": 0.002, "normal_deg": 0.005,
                   "closure_of_path": 0.004}


def ride_settings():
    """The rides' camera (fx 700, principal point at the image centre) at
    the reference feature budget: 2000 features over 8 levels."""
    from pilotguru_tpu_torch.vo.camera import CameraSettings

    return CameraSettings(fx=RIDE_FX, fy=RIDE_FX, cx=RIDE_W / 2.0, cy=RIDE_H / 2.0,
                          orb_features=2000, orb_levels=8)


def ride_pose(t: int, period_frames: float = RIDE_PERIOD,
              forward_speed: float = RIDE_SPEED):
    """True pose of parallax-ride frame ``t``: (camera centre in the world
    [3], world-to-camera rotation [3, 3]); the camera looks down +z, y
    down."""
    centre = np.array(
        [0.9 * np.sin(2 * np.pi * t / period_frames), 0.0, forward_speed * t]
    )
    yaw = 0.25 * np.cos(2 * np.pi * t / period_frames)
    c, s = np.cos(yaw), np.sin(yaw)
    return centre, np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def loop_pose(t: int, radius: float = LOOP_RADIUS, period_frames: int = LOOP_PERIOD):
    """True pose of loop-ride frame ``t``: the camera starts at the origin
    heading +z and drives a circle about (radius, 0, 0), looking along its
    motion; same conventions as ride_pose."""
    phi = 2 * np.pi * t / period_frames
    centre = np.array([radius * (1 - np.cos(phi)), 0.0, radius * np.sin(phi)])
    c, s = np.cos(phi), np.sin(phi)
    return centre, np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _render(poses, pts, shade, width, height, fx, dot_scale, texture=None):
    """Filled squares (one per point, side ~ dot_scale * fx / depth, far to
    near) seen from each (centre, world-to-camera rotation) pose, as uint8
    [height, width] frames; the principal point is the image centre. With
    ``texture`` ([N, T, T] uint8), a square of side >= T shows its point's
    T x T pattern of shades, stretched over it, instead of one shade."""
    cx, cy = width / 2.0, height / 2.0
    for centre, rot in poses:
        local = (pts - centre) @ rot.T
        img = np.full((height, width), 25, np.uint8)
        for i in np.argsort(-local[:, 2]):
            x, y, z = local[i]
            if z < 0.5:
                continue
            u, v = fx * x / z + cx, fx * y / z + cy
            r = max(int(round(dot_scale * fx / z)), 1)
            if -r <= u < width + r and -r <= v < height + r:
                u0, v0 = int(u) - r, int(v) - r
                u1, v1 = int(u) + r, int(v) + r
                rows = slice(max(v0, 0), min(max(v1 + 1, 0), height))
                cols = slice(max(u0, 0), min(max(u1 + 1, 0), width))
                side = 2 * r + 1
                if texture is None or side < texture.shape[1]:
                    img[rows, cols] = shade[i]
                    continue
                cell = np.arange(side) * texture.shape[1] // side
                patch = texture[i][cell[:, None], cell[None, :]]
                img[rows, cols] = patch[rows.start - v0 : rows.stop - v0,
                                        cols.start - u0 : cols.stop - u0]
        yield img


def render_ride(frames: int = RIDE_FRAMES, width: int = RIDE_W,
                height: int = RIDE_H, num_points: int = 2400,
                fx: float = RIDE_FX, seed: int = 7,
                dot_scale: float = 7.0 / 250.0):
    """Yield ``frames`` uint8 [height, width] grayscale frames of the
    parallax ride of tests/synthetic.py::render_parallax_video (filled
    squares on random billboards seen from a planar curving path), drawn
    with numpy slices, so it needs neither cv2 nor a codec. The defaults
    are the 720p ride (2400 billboards, fx 700, a 60-frame lateral period)."""
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-8, 8, num_points), rng.uniform(-4, 4, num_points),
         rng.uniform(4, 16, num_points)],
        axis=1,
    )
    shade = rng.integers(90, 255, num_points)
    yield from _render((ride_pose(t) for t in range(frames)), pts, shade,
                       width, height, fx, dot_scale)


def render_loop_ride(frames: int = LOOP_FRAMES, width: int = RIDE_W,
                     height: int = RIDE_H, num_points: int = 6000,
                     fx: float = RIDE_FX, seed: int = 11,
                     dot_scale: float = 7.0 / 250.0):
    """Yield the loop ride's frames (loop_pose): 6000 billboards in an
    annulus around the circuit, 1.5 to 8 units outside it and up to 2.5
    above or below the camera, drawn like render_ride but each with its own
    3 x 3 pattern of shades, so a revisited place matches by descriptor
    (plain squares give every corner nearly the same ORB descriptor). The
    camera turns 1.25 degrees a frame: at 1.875 degrees a frame the
    tracker, the port's and the reference's alike, loses track every 50 to
    80 frames (PERF.md)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, num_points)
    rad = rng.uniform(LOOP_RADIUS + 1.5, LOOP_RADIUS + 8.0, num_points)
    pts = np.stack([LOOP_RADIUS - rad * np.cos(ang), rng.uniform(-2.5, 2.5, num_points),
                    rad * np.sin(ang)], axis=1)
    shade = rng.integers(90, 255, num_points)
    texture = rng.integers(60, 255, (num_points, 3, 3)).astype(np.uint8)
    yield from _render((loop_pose(t) for t in range(frames)), pts, shade,
                       width, height, fx, dot_scale, texture)


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def sim3_aligned(src, dst):
    """Camera centres ``src`` [N, 3] aligned to ``dst`` by Sim(3)
    (Umeyama): (aligned centres, the rotation, their RMSE to ``dst``,
    ``dst``'s path length)."""
    src = np.asarray(src, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    u, d, vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    sign = np.diag([1.0, 1.0, np.sign(np.linalg.det(u) * np.linalg.det(vt))])
    r = u @ sign @ vt
    c = np.trace(np.diag(d) @ sign) / (((src - mu_s) ** 2).sum() / len(src))
    aligned = (c * (r @ (src - mu_s).T)).T + mu_d
    rmse = np.sqrt(((aligned - dst) ** 2).sum(1).mean())
    return aligned, r, rmse, np.linalg.norm(np.diff(dst, axis=0), axis=1).sum()


def trajectory_errors(traj, pose_of=ride_pose, period=None) -> dict:
    """A written trajectory against the ride's true poses (``pose_of``).

    The tracker's world is its first keyframe's camera at its own scale,
    so rotations compare relative to the segment's first frame (camera i
    in camera 0's frame) and camera centres after a Sim(3) (Umeyama)
    alignment; the fitted plane's normal compares, rotated by that
    alignment, with the ride's ground-plane normal (world y). With
    ``period`` (frames a turn), the closure error is the mean distance
    between the aligned centres of frames i and i + period, which share
    one true place, as a fraction of the true path length."""
    ids = np.asarray(traj.frame_id)
    true_c = np.stack([pose_of(int(i))[0] for i in ids])
    true_c2w = np.stack([pose_of(int(i))[1].T for i in ids])
    est_c2w = np.stack([_quat_to_matrix(q) for q in traj.rotations])
    rot_err = []
    for r_est, r_true in zip(est_c2w, true_c2w):
        d = (est_c2w[0].T @ r_est).T @ (true_c2w[0].T @ r_true)
        rot_err.append(np.degrees(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1))))

    aligned, r, rmse, length = sim3_aligned(traj.translations, true_c)
    normal = r @ np.cross(traj.plane[0], traj.plane[1])
    cos = abs(normal[1]) / np.linalg.norm(normal)
    errors = {
        "rotation_max_deg": float(max(rot_err)),
        "rotation_max_frame": int(ids[int(np.argmax(rot_err))]),
        "rotation_mean_deg": float(np.mean(rot_err)),
        "centre_rmse_of_path": float(rmse / length),
        "normal_deg": float(np.degrees(np.arccos(min(cos, 1.0)))),
    }
    if period is not None:
        row = {int(f): i for i, f in enumerate(ids)}
        pairs = [(row[f], row[f + period]) for f in row if f + period in row]
        gaps = [np.linalg.norm(aligned[a] - aligned[b]) for a, b in pairs]
        # Infinite when no frame pair one turn apart was tracked.
        errors["closure_of_path"] = float(np.mean(gaps) / length) if gaps else float("inf")
    return errors


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30):
    """(device ms, wall ms) of one call, after a warm-up.

    Device ms: the summed duration of the kernels the call ran, from the
    profiler's CUPTI records, averaged over ``reps`` calls. Wall ms: the
    median over ``reps`` calls of CUDA events recorded around each call,
    which includes the host's launch work whenever it outlasts the
    kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    # The profiler now and then records none or only some of the kernels it
    # should: such a measurement is taken again (at most twice).
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and min(e.count for e in events) >= reps:
            break
    device_us = sum(e.device_time_total for e in events)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return device_us / 1e3 / reps, statistics.median(times)


def bound(bytes_moved: float, operations: float, fused: bool = True) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the FP32 peak. The peak
    counts a fused multiply-add as two operations; with ``fused`` false the
    function's contract forbids fusing, every multiply and add issues alone
    and the rate is half the peak."""
    by_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    by_ops = 1e3 * operations / (PEAK_FP32_PER_S if fused else PEAK_FP32_PER_S / 2)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "operations": operations}


def _covered_pixels(h, w, rows, cols) -> int:
    """Distinct image pixels that per-keypoint windows read, from each
    window's row and column indices ([K, S] each)."""
    seen = np.zeros((h, w), bool)
    for r, c in zip(rows, cols):
        seen[np.ix_(r, c)] = True
    return int(seen.sum())


# Two floors for K1, built and timed by this script only (the port calls
# neither): an empty kernel on K1's grid (what a launch of that many blocks
# costs) and a copy that moves K1's bytes on the same grid (the image read
# once, two outputs written).
FLOORS_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void copy_two_kernel(const float* __restrict__ in, float* __restrict__ a,
                                float* __restrict__ b, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float v = in[i];
    a[i] = v;
    b[i] = v;
  }
}
extern "C" int pg_floor_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" int pg_floor_copy_two(const void* in, void* a, void* b, int n, int blocks,
                                 int threads, void* stream) {
  copy_two_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(a), static_cast<float*>(b), n);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_floors():
    """Compile FLOORS_SOURCE into the port's build directory; returns the
    loaded library."""
    import ctypes

    from pilotguru_tpu_torch import cuda_lib

    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_lib.BUILD_DIR / "floors.cu"
    target = cuda_lib.BUILD_DIR / f"libfloors.{os.getpid()}.so"
    src.write_text(FLOORS_SOURCE)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(target), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    lib.pg_floor_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.pg_floor_copy_two.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib


def fast_tiles(shapes) -> int:
    """Blocks of K1's grid: one per 32x32 tile of every image."""
    return sum(-(-h // 32) * -(-w // 32) for h, w in shapes)


def time_fast_floors(floors, images, reps: int = 30):
    """(empty-kernel ms, copy ms) on K1's grid for ``images`` (device ms):
    one launch of fast_tiles blocks of 256 threads; the copy reads all the
    images' pixels once and writes them twice."""
    import torch

    from pilotguru_tpu_torch import cuda_lib

    blocks = fast_tiles([tuple(i.shape) for i in images])
    flat = torch.cat([i.reshape(-1) for i in images])
    a, b = torch.empty_like(flat), torch.empty_like(flat)
    stream = cuda_lib.current_stream(flat.device)

    def launch_empty():
        cuda_lib.check_launch("floor_empty", floors.pg_floor_empty(blocks, 256, stream))

    def launch_copy():
        cuda_lib.check_launch("floor_copy_two", floors.pg_floor_copy_two(
            flat.data_ptr(), a.data_ptr(), b.data_ptr(), flat.numel(), blocks, 256, stream))

    empty_ms = time_ms(launch_empty, reps)[0]
    copy_ms = time_ms(launch_copy, reps)[0]
    if not (torch.equal(a, flat) and torch.equal(b, flat)):
        raise AssertionError("the floor copy did not copy")
    return empty_ms, copy_ms


def check_fast_kernel(rng):
    """K1 against its plain version at the 8 level sizes of a 720p frame and
    at 1080p. Returns the cases (image on the card, error) to time later."""
    import torch

    from pilotguru_tpu_torch.vo.fast_kernel import fast_nms, fast_nms_levels, fast_nms_plain

    cases = []
    for shape in LEVEL_SHAPES_720P + [(1080, 1920)]:
        img = torch.from_numpy(
            rng.uniform(0, 1, size=shape).astype(np.float32)
        ).cuda()
        raw_k, nms_k = fast_nms(img)
        raw_p, nms_p = fast_nms_plain(img)
        torch.cuda.synchronize()
        err = float((raw_k - raw_p).abs().max())
        same_support = bool(torch.equal(nms_k > 0, nms_p > 0))
        corners = int((nms_k > 0).sum())
        if not (err <= 1e-5 and same_support and corners > 0):
            raise AssertionError(
                f"K1 fast_nms disagrees with its plain version at {shape}: "
                f"raw max-abs {err}, same NMS support {same_support}, "
                f"{corners} NMS corners"
            )
        print(f"K1 fast_nms {shape[0]}x{shape[1]}: raw max-abs {err:.3g}, NMS support "
              f"identical ({corners} corners)", flush=True)
        cases.append({"shape": shape, "err": err, "img": img})

    levels = [case["img"] for case in cases[:len(LEVEL_SHAPES_720P)]]
    got = fast_nms_levels(levels)
    torch.cuda.synchronize()
    for (raw_k, nms_k), img in zip(got, levels):
        raw_p, nms_p = fast_nms_plain(img)
        if not (torch.equal(raw_k, raw_p) and torch.equal(nms_k, nms_p)):
            raise AssertionError(
                f"K1 fast_nms_levels differs from fast_nms_plain at {tuple(img.shape)}: "
                f"raw max-abs {float((raw_k - raw_p).abs().max())}"
            )
    print(f"K1 fast_nms_levels, {len(levels)} levels in one launch: raw and NMS equal "
          "to the plain version at every level", flush=True)
    return cases


def _fast_bound(shapes) -> dict:
    """K1 reads each image once and writes raw and nms; per pixel 16 tap
    differences, 32 threshold compares and 9 maxima (the sums of the taps
    over the threshold depend on the data and are not counted)."""
    pixels = sum(h * w for h, w in shapes)
    return bound(12 * pixels, 57 * pixels)


def time_fast_kernel(cases, ride_gray):
    """Device ms of K1 one level at a time (uniform-noise images, the
    shapes of check_fast_kernel) and of the all-level call, on the noise
    pyramid and on the pyramid of a ride frame, with the two floors on the
    same grids. Returns (per-level rows, all-level row)."""
    import torch

    from pilotguru_tpu_torch.vo.fast_kernel import fast_nms, fast_nms_levels, fast_nms_plain
    from pilotguru_tpu_torch.vo.features import resize_linear

    floors = build_floors()
    levels = [case["img"] for case in cases[:len(LEVEL_SHAPES_720P)]]
    for case in cases:
        img, shape = case.pop("img"), case["shape"]
        ms, wall = time_ms(lambda: fast_nms(img))
        plain_ms, plain_wall = time_ms(lambda: fast_nms_plain(img), reps=10)
        case.update(ms=ms, plain_ms=plain_ms, **_fast_bound([shape]))
        print(
            f"K1 fast_nms {shape[0]}x{shape[1]}: device ms kernel {ms:.4f}, plain "
            f"{plain_ms:.4f}, bound {case['bound_ms']:.4f}; wall ms kernel {wall:.4f}, "
            f"plain {plain_wall:.4f}", flush=True,
        )
    empty_ms, copy_ms = time_fast_floors(floors, levels[:1])
    print(f"K1 floors on the 720x1280 grid ({fast_tiles(LEVEL_SHAPES_720P[:1])} blocks): "
          f"empty kernel {empty_ms:.4f} ms, copy of the same bytes {copy_ms:.4f} ms",
          flush=True)

    row = {"err": max(c["err"] for c in cases), **_fast_bound(LEVEL_SHAPES_720P)}
    row["ms"], wall = time_ms(lambda: fast_nms_levels(levels))
    row["plain_ms"], _ = time_ms(lambda: [fast_nms_plain(i) for i in levels], reps=10)
    frame = torch.from_numpy(ride_gray.astype(np.float32) / 255.0).cuda()
    ride_levels = [frame] + [resize_linear(frame, h, w) for h, w in LEVEL_SHAPES_720P[1:]]
    row["ride_ms"], _ = time_ms(lambda: fast_nms_levels(ride_levels))
    row["empty_ms"], row["copy_ms"] = time_fast_floors(floors, levels)
    print(
        f"K1 fast_nms_levels, 8 levels of 720p in one launch "
        f"({fast_tiles(LEVEL_SHAPES_720P)} blocks): device ms kernel {row['ms']:.4f} on "
        f"noise, {row['ride_ms']:.4f} on a ride frame, plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f}; floors: empty kernel {row['empty_ms']:.4f}, copy of the "
        f"same bytes {row['copy_ms']:.4f}; wall ms kernel {wall:.4f}", flush=True,
    )
    return cases, row


def _keypoints_720p(rng, h, w, k=434):
    """``k`` random keypoints, then 8 within 27 px (K3's blur radius 8 +
    patch radius 19) of each border and the four corners."""
    near = [
        np.stack([rng.integers(0, 27, 8), rng.integers(0, w, 8)], axis=1),
        np.stack([rng.integers(h - 27, h, 8), rng.integers(0, w, 8)], axis=1),
        np.stack([rng.integers(0, h, 8), rng.integers(0, 27, 8)], axis=1),
        np.stack([rng.integers(0, h, 8), rng.integers(w - 27, w, 8)], axis=1),
    ]
    return np.concatenate(
        [np.stack([rng.integers(0, h, k), rng.integers(0, w, k)], axis=1), *near,
         np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]])]
    ).astype(np.int32)


def check_patch_kernel(rng):
    """K2 against its plain version on a 720p image, and its all-level call
    (one launch over the 8 level sizes, the extractor's budgets plus border
    and corner keypoints) against 8 plain calls. Returns (the one-level
    case, the all-level case) to time later."""
    import torch

    from pilotguru_tpu_torch.vo.patch_kernel import (
        gather_patches,
        gather_patches_levels,
        gather_patches_plain,
    )

    h, w = 720, 1280
    img = torch.from_numpy(rng.uniform(0, 1, size=(h, w)).astype(np.float32)).cuda()
    yx = torch.from_numpy(_keypoints_720p(rng, h, w)).cuda()
    got = gather_patches(img, yx)
    want = gather_patches_plain(img, yx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K2 gather_patches differs from plain: max-abs {err}")
    print(f"K2 gather_patches 720p, K={yx.shape[0]} (434 random, 32 near the border, "
          f"4 corners): exact", flush=True)

    images = [img] + [torch.from_numpy(rng.uniform(0, 1, size=shape).astype(np.float32)).cuda()
                      for shape in LEVEL_SHAPES_720P[1:]]
    yx_levels = [torch.from_numpy(_keypoints_720p(rng, h, w, k)).cuda()
                 for (h, w), k in zip(LEVEL_SHAPES_720P, LEVEL_BUDGETS_2000)]
    got = gather_patches_levels(images, yx_levels)
    torch.cuda.synchronize()
    for patches, image, level_yx in zip(got, images, yx_levels):
        want = gather_patches_plain(image, level_yx)
        if not torch.equal(patches, want):
            raise AssertionError("K2 gather_patches_levels differs from the plain version at "
                                 f"{tuple(image.shape)}: max-abs "
                                 f"{float((patches - want).abs().max())}")
    print(f"K2 gather_patches_levels, 8 levels in one launch, K="
          f"{[int(p.shape[0]) for p in yx_levels]} (the budgets of 2000 features, each plus "
          "32 near the border and 4 corners): exact at every level", flush=True)
    one = {"err": err, "img": img, "yx": yx[:434].contiguous()}
    every = {"err": err, "images": images,
             "yx": [p[: p.shape[0] - 36].contiguous() for p in yx_levels]}
    return one, every


def _patch_windows(img, yx):
    """K2's clamped window row and column indices ([K, 39] each)."""
    import torch

    from pilotguru_tpu_torch.vo.patch_kernel import PATCH_GATHER_RADIUS

    h, w = img.shape
    offs = torch.arange(-PATCH_GATHER_RADIUS, PATCH_GATHER_RADIUS + 1, device=yx.device)
    rows = (yx[:, 0:1].long().clamp(0, h - 1) + offs).clamp(0, h - 1)
    cols = (yx[:, 1:2].long().clamp(0, w - 1) + offs).clamp(0, w - 1)
    return rows, cols


def _patch_bound(images_and_yx) -> dict:
    """K2 reads the distinct pixels the windows cover and the keypoints once
    and writes the patches."""
    covered = k = 0
    for img, yx in images_and_yx:
        rows, cols = _patch_windows(img, yx)
        covered += _covered_pixels(*img.shape, rows.cpu().numpy(), cols.cpu().numpy())
        k += yx.shape[0]
    size = rows.shape[1]
    return {**bound(4 * covered + 8 * k + 4 * k * size * size, 0), "covered": covered}


def _library_gather(images_and_yx):
    """The library yardstick for K2: one advanced-index gather from the
    levels' pixels laid end to end, with the clamped window indices (and the
    levels' offsets) precomputed."""
    import torch

    flat, index, base = [], [], 0
    for img, yx in images_and_yx:
        rows, cols = _patch_windows(img, yx)
        index.append(base + rows[:, :, None] * img.shape[1] + cols[:, None, :])
        flat.append(img.reshape(-1))
        base += img.numel()
    flat = torch.cat(flat)
    index = torch.cat(index)
    return lambda: flat[index]


def time_patch_kernel(cases):
    """Device ms of K2 one level (720p, K=434) and of the all-level call at
    the extractor's budgets (8 levels, K=2000), each beside its plain
    version, the library gather and the bound. Returns (one-level row,
    all-level row)."""
    from pilotguru_tpu_torch.vo.patch_kernel import (
        gather_patches,
        gather_patches_levels,
        gather_patches_plain,
    )

    one, every = cases
    img, yx = one.pop("img"), one.pop("yx")
    ms, wall = time_ms(lambda: gather_patches(img, yx))
    plain_ms, plain_wall = time_ms(lambda: gather_patches_plain(img, yx))
    library_ms, library_wall = time_ms(_library_gather([(img, yx)]))
    one.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **_patch_bound([(img, yx)]))
    print(
        f"K2 gather_patches 720p, K=434: device ms kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}, library gather {library_ms:.4f}, bound "
        f"{one['bound_ms']:.4f} ({one['covered']} image pixels read); wall ms kernel "
        f"{wall:.4f}, plain {plain_wall:.4f}, library {library_wall:.4f}", flush=True,
    )
    images, yx_levels = every.pop("images"), every.pop("yx")
    pairs = list(zip(images, yx_levels))
    ms, wall = time_ms(lambda: gather_patches_levels(images, yx_levels))
    plain_ms, _ = time_ms(lambda: [gather_patches_plain(i, y) for i, y in pairs])
    library_ms, library_wall = time_ms(_library_gather(pairs))
    every.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **_patch_bound(pairs))
    print(
        f"K2 gather_patches_levels, 8 levels in one launch, K="
        f"{sum(int(y.shape[0]) for y in yx_levels)}: device ms kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}, library gather {library_ms:.4f}, bound {every['bound_ms']:.4f} "
        f"({every['bytes'] / 1e6:.2f} MB, {every['covered']} image pixels read); wall ms "
        f"kernel {wall:.4f}, library {library_wall:.4f}", flush=True,
    )
    return one, every


def check_blur_patch_kernel(rng):
    """K3 against its plain version at the 8 level sizes of a 720p frame.
    Returns the cases to time later."""
    import torch

    from pilotguru_tpu_torch.vo.patch_kernel import (
        gather_blurred_patches,
        gather_blurred_patches_levels,
        gather_blurred_patches_plain,
    )

    cases = []
    for shape in LEVEL_SHAPES_720P:
        h, w = shape
        img = torch.from_numpy(rng.uniform(0, 1, size=shape).astype(np.float32)).cuda()
        yx = torch.from_numpy(_keypoints_720p(rng, h, w)).cuda()
        got = gather_blurred_patches(img, yx)
        want = gather_blurred_patches_plain(img, yx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"K3 gather_blurred_patches differs from plain at {shape}: max-abs {err}"
            )
        print(f"K3 gather_blurred_patches {h}x{w}, K={yx.shape[0]} (434 random, 32 near "
              f"the border, 4 corners): exact", flush=True)
        cases.append({"shape": shape, "err": err, "img": img, "yx": yx[:434].contiguous()})

    images = [case["img"] for case in cases]
    yx_levels = [
        torch.from_numpy(_keypoints_720p(rng, h, w, k)).cuda()
        for (h, w), k in zip(LEVEL_SHAPES_720P, LEVEL_BUDGETS_2000)
    ]
    got = gather_blurred_patches_levels(images, yx_levels)
    torch.cuda.synchronize()
    for patches, img, yx in zip(got, images, yx_levels):
        if not torch.equal(patches, gather_blurred_patches_plain(img, yx)):
            raise AssertionError("K3 gather_blurred_patches_levels differs from the plain "
                                 f"version at {tuple(img.shape)}")
    print(f"K3 gather_blurred_patches_levels, 8 levels in one launch, K="
          f"{[int(yx.shape[0]) for yx in yx_levels]} (the budgets of 2000 features, each "
          "plus 32 near the border and 4 corners): exact at every level", flush=True)
    for case, yx in zip(cases, yx_levels):
        case["yx_budget"] = yx[: yx.shape[0] - 36].contiguous()
    return cases


def time_blur_patch_kernel(cases):
    """Device ms of K3 per level (434 keypoints each) and of the all-level
    call at the extractor's budgets (2000 keypoints). Returns (per-level
    rows, all-level row)."""
    import torch

    from pilotguru_tpu_torch.vo.patch_kernel import (
        PATCH_GATHER_RADIUS,
        _reflect_edge_index,
        gather_blurred_patches,
        gather_blurred_patches_levels,
        gather_blurred_patches_plain,
        gaussian_kernel,
    )

    taps, br = gaussian_kernel(2.0)
    size = 2 * PATCH_GATHER_RADIUS + 1
    win = size + 2 * br
    offs = torch.arange(win, device="cuda")

    def blur_bound(images_and_yx) -> dict:
        # Reads the distinct window pixels, the keypoints and the taps once,
        # writes the patches; per keypoint a vertical pass (size x win sums)
        # and a horizontal one (size x size), each sum 17 multiplies and 16
        # adds that the contract forbids to fuse.
        covered = k = 0
        for img, yx in images_and_yx:
            h, w = img.shape
            rows = _reflect_edge_index(yx[:, 0:1].long() + offs, h, PATCH_GATHER_RADIUS, br)
            cols = _reflect_edge_index(yx[:, 1:2].long() + offs, w, PATCH_GATHER_RADIUS, br)
            covered += _covered_pixels(h, w, rows.cpu().numpy(), cols.cpu().numpy())
            k += yx.shape[0]
        return bound(4 * covered + 8 * k + 4 * len(taps) + 4 * k * size * size,
                     k * (size * win + size * size) * (2 * len(taps) - 1), fused=False)

    images = [case["img"] for case in cases]
    yx_levels = [case.pop("yx_budget") for case in cases]
    for case in cases:
        img, yx = case.pop("img"), case.pop("yx")
        h, w = case["shape"]
        ms, wall = time_ms(lambda: gather_blurred_patches(img, yx))
        plain_ms, plain_wall = time_ms(lambda: gather_blurred_patches_plain(img, yx))
        case.update(ms=ms, plain_ms=plain_ms, **blur_bound([(img, yx)]))
        print(
            f"K3 gather_blurred_patches {h}x{w}, K=434: device ms kernel {ms:.4f}, plain "
            f"{plain_ms:.4f}, bound {case['bound_ms']:.4f} ({case['bound_by']}; "
            f"{case['bytes'] / 1e6:.2f} MB, {case['operations'] / 1e6:.1f} MFLOP unfused); "
            f"wall ms kernel {wall:.4f}, plain {plain_wall:.4f}", flush=True,
        )
    row = {"err": max(c["err"] for c in cases), **blur_bound(list(zip(images, yx_levels)))}
    row["ms"], wall = time_ms(lambda: gather_blurred_patches_levels(images, yx_levels))
    row["plain_ms"], _ = time_ms(
        lambda: [gather_blurred_patches_plain(i, y) for i, y in zip(images, yx_levels)])
    print(
        f"K3 gather_blurred_patches_levels, 8 levels in one launch, K="
        f"{sum(int(y.shape[0]) for y in yx_levels)}: device ms {row['ms']:.4f} (the kernel "
        f"and the concatenation of the 8 keypoint sets), plain {row['plain_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}; {row['bytes'] / 1e6:.2f} MB, "
        f"{row['operations'] / 1e6:.1f} MFLOP unfused); wall ms {wall:.4f}", flush=True,
    )
    return cases, row


# The fused batch norm + ReLU (csrc/bn_relu.cuh) at the benchmark cells'
# shapes: the train-mode batch norms of one folded PilotNet step, x3 (the
# train cell) and x12 (the search cell), at batch 1,024.
BN_NETS = (3, 12)
BN_BATCH = 1024


def bn_relu_layers(nets: int, dtype: str = "float32", batch: int = BN_BATCH) -> list:
    """What each fused batch norm of one folded PilotNet x``nets`` train step
    receives, as the path lays it out: (x, scale, bias, mean_ra, var_ra) per
    layer, copied from a step on uint8 frames."""
    import torch

    from pilotguru_tpu_torch.ml import augmentation, bn_relu_kernel, models, training

    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 2,
               "dropout_prob": 0.0, "compute_dtype": dtype}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    tx = training.make_optimizer("sgd", 1e-3)
    state = training.init_ensemble(model, {}, nets, tx, seed=1, device="cuda")
    settings = training.TrainSettings(epochs=1, batch_size=batch,
                                      augment=augmentation.AugmentSettings(target_width=200))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (batch, 66, 200, 3), dtype=np.uint8)
    axis = rng.normal(size=(batch, 3)).astype(np.float32)
    inputs = {"frame_img": torch.as_tensor(frames).cuda(),
              "forward_axis": torch.as_tensor(axis).cuda()}
    labels = torch.as_tensor(rng.normal(0, 0.3, (batch, 2)).astype(np.float32)).cuda()
    layers, original = [], bn_relu_kernel.bn_relu_train

    def keep(x, *rest):
        layers.append(tuple(t.detach().clone(memory_format=torch.preserve_format)
                            for t in (x, *rest[:4])))
        return original(x, *rest)

    bn_relu_kernel.bn_relu_train = keep
    try:
        training.make_train_step(model, tx, settings)(
            state, inputs, labels, torch.ones((nets, batch), device="cuda"),
            torch.ones(nets, dtype=torch.bool, device="cuda"), torch.Generator(device="cuda"))
    finally:
        bn_relu_kernel.bn_relu_train = original
    torch.cuda.synchronize()
    return layers


def _bn_relu_both(layers, grads):
    """Each layer forward and backward through the kernels and the plain
    version (its backward from the kernels' statistics, so both take the
    same ReLU mask): the largest gap of y and dx against the largest value,
    and of the statistics and dscale / dbias (relative)."""
    import torch

    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    worst = {"y": 0.0, "dx": 0.0, "stats": 0.0, "grads": 0.0}
    for (x, scale, bias, mean_ra, var_ra), g in zip(layers, grads):
        y, stats = bk._forward_cuda(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
        dx, dgrads = bk._backward_cuda(g, x, scale, bias, stats)
        y_p, stats_p = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
        dx_p, dgrads_p = bk.bn_relu_backward_plain(g, x, scale, bias, stats)
        for key, got, want in (("y", y, y_p), ("dx", dx, dx_p)):
            gap = (got.float() - want.float()).abs().max() / want.float().abs().max()
            worst[key] = max(worst[key], float(gap))
        for key, got, want in (("stats", stats, stats_p), ("grads", dgrads, dgrads_p)):
            gap = ((got - want).abs() / want.abs().clamp(min=1e-30)).max()
            worst[key] = max(worst[key], float(gap))
        if not torch.equal(stats[2], stats_p[2]):
            raise AssertionError("bn_relu: the clamp's channels differ from the plain version's")
    return worst


# The kernels against the plain version over a step's layers: the same
# float32 operations, float64 sums in another order, so statistics within
# two float32 ulps, y and dx within 1e-6 of their largest value in float32
# and one bfloat16 ulp (2^-7) of it in bfloat16 (tests/test_torch_cuda.py).
BN_BARS = {"float32": {"y": 1e-6, "dx": 1e-6, "stats": 2.4e-7, "grads": 2.4e-7},
           "bfloat16": {"y": 2.0**-7, "dx": 2.0**-7, "stats": 2.4e-7, "grads": 2.4e-7}}


def check_bn_relu_kernel():
    """The fused batch norm + ReLU pair against its plain version over the
    layers of a PilotNet x3 step, in float32 and bfloat16."""
    import torch

    rows = {}
    for dtype in ("float32", "bfloat16"):
        layers = bn_relu_layers(BN_NETS[0], dtype)
        gen = torch.Generator(device="cuda").manual_seed(7)
        grads = [torch.empty_like(x).normal_(generator=gen) for x, *_ in layers]
        worst = _bn_relu_both(layers, grads)
        rows[dtype] = worst
        shapes = [tuple(x.shape) for x, *_ in layers]
        print(f"bn_relu ({dtype}, {len(layers)} layers of a PilotNet x{BN_NETS[0]} step: "
              f"{shapes}): largest gaps from the plain version {json.dumps(worst)}", flush=True)
        over = {k: v for k, v in worst.items() if v > BN_BARS[dtype][k]}
        if over:
            raise AssertionError(f"bn_relu {dtype}: over BN_BARS {over}")
    return rows


def time_bn_relu_kernel():
    """Device ms of the fused pair over one step's layers (forward and
    backward), for PilotNet x3 and x12 at batch 1,024 in float32, beside the
    bound (each input byte read once, each output written once, at the
    memory rate), the two-pass design's own traffic, the plain version and
    the op-by-op PyTorch expression it replaced (``bn_train_ops``, the cast
    and the ReLU through autograd)."""
    import torch
    import torch.nn.functional as F

    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    rows = []
    for nets in BN_NETS:
        layers = bn_relu_layers(nets)
        grads = [torch.ones_like(x) for x, *_ in layers]

        def fused():
            for (x, scale, bias, mean_ra, var_ra), g in zip(layers, grads):
                _, stats = bk._forward_cuda(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
                bk._backward_cuda(g, x, scale, bias, stats)

        def plain():
            for (x, scale, bias, mean_ra, var_ra), g in zip(layers, grads):
                _, stats = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
                bk.bn_relu_backward_plain(g, x, scale, bias, stats)

        def replaced():
            for (x, scale, bias, mean_ra, var_ra), g in zip(layers, grads):
                xr, sr, br = (t.detach().requires_grad_(True) for t in (x, scale, bias))
                y, _, _ = bk.bn_train_ops(xr, sr, br, mean_ra, var_ra, 1e-5, 0.9)
                F.relu(y.to(x.dtype)).backward(g)

        activation = sum(x.numel() * x.element_size() for x, *_ in layers)
        elements = sum(x.numel() for x, *_ in layers)
        # Forward reads x, writes y; backward reads g and x, writes dx. About
        # 24 float32 operations an element over the four passes.
        row = {"nets": nets, "layers": len(layers), "activation_bytes": activation,
               **bound(5 * activation, 24 * elements)}
        row["design_ms"] = 1e3 * 8 * activation / PEAK_BYTES_PER_S
        row["ms"], row["wall_ms"] = time_ms(fused, reps=10)
        row["plain_ms"], _ = time_ms(plain, reps=3)
        row["replaced_ms"], _ = time_ms(replaced, reps=10)
        rows.append(row)
        print(f"bn_relu, the {len(layers)} batch norms of a PilotNet x{nets} step at batch "
              f"{BN_BATCH} ({activation / 1e9:.3f} GB of activations), forward and backward: "
              f"device ms {row['ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}; "
              f"5 passes), the design's 8 passes {row['design_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, the op-by-op expression it replaced "
              f"{row['replaced_ms']:.4f}; wall ms {row['wall_ms']:.4f}", flush=True)
        del layers, grads
        torch.cuda.empty_cache()
    return rows


# The folded convolutions' backward (csrc/conv_bwd.cuh) at the training
# cells' shapes: every conv of one folded step of PilotNet x3 (the train
# cell), x12 (the search cell) and Rambo x3, at batch 1,024.
CONV_CELLS = (("nvidia", 3), ("nvidia", 12), ("rambo", 3))
# Each gradient against the plain version, as a share of its norm: the
# kernels sum in one float32 FMA chain what the plain version sums through
# cuBLAS; against float64 the kernels read at most 6e-6 of the norm at these
# layers (tests/test_torch_cuda.py::test_conv_bwd_kernels_match_plain).
CONV_BAR = 2e-5


def conv_bwd_layers(net: str, nets: int, batch: int = BN_BATCH) -> list:
    """What each folded conv of one x``nets`` float32 train step of ``net``
    receives, as the path lays it out: (x, kernel, stride, groups) per conv,
    copied from a step on uint8 frames."""
    import torch

    from pilotguru_tpu_torch.ml import conv_kernel, models, training

    height, width = (66, 200) if net == "nvidia" else (100, 300)
    options = {"net_name": net, "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (height, width, 3))
    state = training.init_ensemble(model, {}, nets, training.make_optimizer("sgd", 1e-3),
                                   seed=1, device="cuda")
    rng = np.random.default_rng(6)
    frames = torch.as_tensor(rng.integers(0, 256, (batch, height, width, 3), dtype=np.uint8))
    inputs = {"frame_img": frames.cuda().float() / 255.0,
              "forward_axis": torch.as_tensor(rng.normal(size=(batch, 3)).astype(np.float32)).cuda()}
    layers, original = [], conv_kernel.folded_conv

    def keep(x, kernel, bias, stride, groups):
        layers.append((x.detach().clone(memory_format=torch.preserve_format),
                       kernel.detach().clone(), conv_kernel._square(stride), groups))
        return original(x, kernel, bias, stride, groups)

    conv_kernel.folded_conv = keep
    try:
        with torch.no_grad():
            training._forward_for(model)(model, state.params, state.batch_stats, inputs, True,
                                         torch.Generator(device="cuda"))
    finally:
        conv_kernel.folded_conv = original
    torch.cuda.synchronize()
    return layers


def _conv_dy(x, kernel, stride, groups, seed=7):
    """A unit-normal upstream gradient of the conv's output, channels-last."""
    import torch

    b, _, h, w = x.shape
    k = kernel.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((b, kernel.shape[0] * kernel.shape[4], (h - k) // stride + 1,
                      (w - k) // stride + 1), generator=gen, device="cuda")
    return dy.contiguous(memory_format=torch.channels_last)


def _conv_pair(x, kernel, dy, stride, groups, plain=False):
    """(dx or None for a shared input, dW, db) through the kernels or the
    plain version."""
    from pilotguru_tpu_torch.ml import conv_kernel as ck

    nets, k, _, cin, cout = kernel.shape
    dx = None
    if groups == nets:
        w = ck._dgrad_weights(kernel)
        dx = (ck.conv_dgrad_plain(dy, w, x.shape, stride) if plain
              else ck._dgrad_cuda(dy, w, tuple(x.shape), stride))
    if plain:
        b, cy, ho, wo = dy.shape
        splits = ck.wgrad_mapping(b * ho * wo, groups, cin, cy // groups, k)[-1]
        return (dx, *ck.conv_wgrad_plain(x, dy, groups, k, stride, cout, splits))
    return (dx, *ck._wgrad_cuda(x, dy, tuple(kernel.shape), stride, groups))


def check_conv_bwd_kernel():
    """The conv backward pair against its plain version at every conv of the
    three cells' steps, within CONV_BAR of each gradient's norm, and two
    calls equal to the bit."""
    import torch

    worst = {}
    for net, nets in CONV_CELLS:
        gaps = {"dx": 0.0, "dw": 0.0, "db": 0.0}
        for x, kernel, stride, groups in conv_bwd_layers(net, nets):
            dy = _conv_dy(x, kernel, stride, groups)
            got = _conv_pair(x, kernel, dy, stride, groups)
            again = _conv_pair(x, kernel, dy, stride, groups)
            want = _conv_pair(x, kernel, dy, stride, groups, plain=True)
            torch.cuda.synchronize()
            for key, a, a2, b in zip(("dx", "dw", "db"), got, again, want):
                if b is None:
                    continue
                if not torch.equal(a, a2):
                    raise AssertionError(f"conv backward {key}: two calls differ ({net} x{nets}, "
                                         f"{tuple(x.shape)})")
                gaps[key] = max(gaps[key], float((a - b).norm() / b.norm()))
            del x, kernel, dy, got, again, want
        torch.cuda.empty_cache()
        worst[f"{net}_x{nets}"] = gaps
        print(f"conv backward ({net} x{nets}, every conv of a step at batch {BN_BATCH}): "
              f"largest gaps from the plain version, of the norm, {json.dumps(gaps)}; "
              "two calls equal to the bit", flush=True)
        if max(gaps.values()) > CONV_BAR:
            raise AssertionError(f"conv backward {net} x{nets}: over CONV_BAR {gaps}")
    return worst


def time_conv_bwd_kernel():
    """Device ms of the conv backward pair at each conv of the three cells'
    steps, beside its bound (the FMAs at the FP32 peak: wgrad every conv,
    dgrad but a trunk's first), the plain version and cuDNN's deterministic
    backward of the same conv (``aten.convolution_backward``, as autograd
    calls it: the input's, the weight's and the bias's gradients, TF32 off),
    which the port's float32 training no longer calls. Raises where the
    pair is slower than cuDNN at any layer, by CUDA events (the profiler now
    and then records none of a call's kernels, and its device ms then reads
    0)."""
    import torch

    from pilotguru_tpu_torch.ml import conv_kernel as ck

    rows = []
    for net, nets in CONV_CELLS:
        cell = {"net": net, "nets": nets, "layers": []}
        for x, kernel, stride, groups in conv_bwd_layers(net, nets):
            dy = _conv_dy(x, kernel, stride, groups)
            n, k, _, cin, cout = kernel.shape
            ho, wo = dy.shape[2:]
            shared = groups != n
            macs = x.shape[0] * ho * wo * n * cout * cin * k * k
            weight = ck.fold_conv_kernel(kernel)

            def cudnn():
                torch.ops.aten.convolution_backward(
                    dy, x, weight, [n * cout], [stride, stride], [0, 0], [1, 1], False, [0, 0],
                    groups, [not shared, True, True])

            row = {"shape": f"{tuple(x.shape)} {k}x{k}/{stride} groups {groups} -> "
                            f"{n * cout} channels", **bound(0, 2 * macs * (1 if shared else 2))}
            row["ms"], row["wall_ms"] = time_ms(
                lambda: _conv_pair(x, kernel, dy, stride, groups), reps=10)
            row["plain_ms"], _ = time_ms(
                lambda: _conv_pair(x, kernel, dy, stride, groups, plain=True), reps=1)
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                row["library_ms"], row["library_wall_ms"] = time_ms(cudnn, reps=10)
            cell["layers"].append(row)
            print(f"conv backward {net} x{nets} {row['shape']}: device ms {row['ms']:.4f}, bound "
                  f"{row['bound_ms']:.4f} ({row['operations'] / 1e9:.1f} GFLOP), plain "
                  f"{row['plain_ms']:.4f}, cuDNN deterministic {row['library_ms']:.4f}; wall ms "
                  f"{row['wall_ms']:.4f}, cuDNN {row['library_wall_ms']:.4f}", flush=True)
            del x, kernel, dy, weight
        torch.cuda.empty_cache()
        for key in ("ms", "bound_ms", "plain_ms", "library_ms"):
            cell[key] = sum(r[key] for r in cell["layers"])
        print(f"conv backward, the {len(cell['layers'])} convs of a {net} x{nets} step: device ms "
              f"{cell['ms']:.4f}, bound {cell['bound_ms']:.4f}, plain {cell['plain_ms']:.4f}, "
              f"cuDNN deterministic {cell['library_ms']:.4f}", flush=True)
        rows.append(cell)
    slower = [(c["net"], c["nets"], r["shape"]) for c in rows for r in c["layers"]
              if r["wall_ms"] > r["library_wall_ms"]]
    if slower:
        raise AssertionError(f"conv backward pair slower than cuDNN at {slower}")
    return rows


def check_extractor_cuda_vs_cpu(gray, patch_impl):
    """The extractor on the card (kernels) against the CPU (plain versions)
    on one ride frame: same keypoints, and descriptors equal except where a
    keypoint's angle sits within 1e-4 rad of a steering-bin boundary."""
    import torch

    from pilotguru_tpu_torch.vo.features import (
        BRIEF_ANGLE_BINS,
        extract_orb_features,
    )

    img = torch.from_numpy(gray.astype(np.float32) / 255.0)
    cpu = extract_orb_features(img, num_levels=8, total_budget=2000, patch_impl=patch_impl)
    gpu = extract_orb_features(img.cuda(), num_levels=8, total_budget=2000,
                               patch_impl=patch_impl)
    gpu = type(gpu)(*(t.cpu() for t in gpu))
    if not torch.equal(cpu.valid, gpu.valid) or not torch.equal(cpu.level, gpu.level):
        raise AssertionError(f"extractor ({patch_impl}): keypoint sets differ between "
                             "CUDA and CPU")
    valid = cpu.valid
    # Every stage but the orientation moment sums is device-independent
    # (tap-by-tap resize and blur, same-order FAST): xy must match exactly.
    xy_err = float((cpu.xy - gpu.xy)[valid].abs().max())
    if xy_err != 0.0:
        raise AssertionError(f"extractor ({patch_impl}): keypoint xy differ by {xy_err} px")
    same = (cpu.descriptors == gpu.descriptors).all(dim=1) | ~valid
    step = 2 * np.pi / BRIEF_ANGLE_BINS
    frac = (cpu.angle / step).numpy() % 1.0
    near_edge = torch.from_numpy(np.abs(frac - 0.5) * step < 1e-4)
    bad = ~same & ~near_edge
    if bool(bad.any()):
        raise AssertionError(
            f"extractor ({patch_impl}): {int(bad.sum())} descriptors differ away "
            "from bin edges"
        )
    n_valid = int(valid.sum())
    print(
        f"extractor ({patch_impl}) CUDA vs CPU on a ride frame: {n_valid} valid "
        f"keypoints identical, xy max-abs {xy_err:.3g} px, "
        f"{int((~same).sum())} descriptors differ (all at bin edges)",
        flush=True,
    )
    if n_valid < 500:
        raise AssertionError(f"extractor ({patch_impl}): only {n_valid} valid keypoints")


class _StepClock:
    """Host milliseconds and calls of chosen functions (no synchronisation:
    each of the loop-closure steps ends in a device-to-host copy)."""

    def __init__(self):
        self.totals = {}
        self._undo = []

    def wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ms, calls = self.totals.get(name, (0.0, 0))
                self.totals[name] = (ms + 1e3 * (time.perf_counter() - start), calls + 1)

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)


class _ProfileWindow:
    """torch.profiler (CUDA activity) over the chunks that start at frame
    ids in [first, last), from a synchronized start to a synchronized
    stop: the device's busy time there, kernels and copies of every thread
    (the prefetch worker's extraction too), against the host's wall time.
    ``spent`` is the window's whole cost to the run, the profiler's start
    and stop included, which the run's frames/s leaves out."""

    def __init__(self, frames):
        self.first, self.last = frames
        self.profiler = None
        self.opened = self.start = self.wall = self.spent = None
        self.frame_span = None

    def hook(self, clock, tracker_class):
        chunk = tracker_class.process_chunk
        window = self

        def windowed(tracker, frames):
            window.at(frames[0].frame_id)
            return chunk(tracker, frames)

        tracker_class.process_chunk = windowed
        clock._undo.append((tracker_class, "process_chunk", chunk))

    def at(self, frame_id):
        import torch

        if self.profiler is None and self.start is None and frame_id >= self.first:
            self.opened = time.perf_counter()
            torch.cuda.synchronize()
            self.profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.profiler.start()
            self.start, self.frame_span = time.perf_counter(), [frame_id, None]
        elif self.profiler is not None and self.wall is None and frame_id >= self.last:
            self._stop(frame_id)

    def _stop(self, frame_id):
        import torch

        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.start
        self.profiler.stop()
        self.spent = time.perf_counter() - self.opened
        self.frame_span[1] = frame_id

    def close(self):
        if self.profiler is not None and self.wall is None:
            raise AssertionError(f"profile window {self.first}..{self.last}: the ride "
                                 "ended inside it")

    def row(self) -> dict:
        import torch

        if self.wall is None:
            raise AssertionError(f"profile window {self.first}..{self.last}: never opened")
        busy_us = sum(e.device_time_total for e in self.profiler.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        frames = self.frame_span[1] - self.frame_span[0]
        return {"frames": frames, "first": self.frame_span[0], "wall_s": self.wall,
                "spent_s": self.spent, "device_busy_ms": busy_us / 1e3,
                "idle_share": 1.0 - busy_us / 1e6 / self.wall}


def run_path(name, frames_u8, out_dir, patch_impl, launches_per_frame,
             pose_of, bars, period=None, expect_loops=False, untimed=None,
             per_frame=True, profile_window=None):
    """Drive optical_trajectories' segment loop over ``frames_u8`` on CUDA
    at 2000 features / 8 levels, with the kernel counts set to 0 just before
    and read just after. ``per_frame``: features extracted inline and frames
    tracked one at a time (``feature_batch_size=0``, a tracker with
    ``track_chunk_frames=0``), else the loop's defaults, the CLI's: decode
    and feature prefetch threads, chunks of 16 through keyframes. Checks:
    every frame in one segment, each kernel launched
    ``launches_per_frame[kernel]`` times a frame (0: not at all), no plain
    version on a CUDA tensor, loop closures (at least one with
    ``expect_loops``, else none) and the written trajectory within ``bars``
    of the true poses. ``untimed``: a dict whose "seconds" the smoke's own
    instrumentation spent inside the run (phase 7's map save,
    capture_parallax_state), taken off the run's seconds and its track
    stage. ``profile_window``: (first, last) frame ids; the chunks that
    start in [first, last) run under torch.profiler (CUDA activity), whose
    device busy time gives the device's idle share there; the window's
    frames and its whole time, the profiler's start and stop included, are
    taken off the run's seconds and frames/s. Returns (the launch counts,
    the seconds, the row)."""
    import torch

    from pilotguru_tpu_torch.formats.trajectory import read_trajectory
    from pilotguru_tpu_torch.vo import (
        fast_kernel,
        loopclosing,
        patch_kernel,
        pipeline,
        posegraph,
        tracking,
    )
    settings = ride_settings()
    frames = (
        pipeline.VideoFrame(g, i, int(round(i * 1e6 / 30.0)))
        for i, g in enumerate(frames_u8)
    )
    counters = (fast_kernel.COUNTER, patch_kernel.COUNTER, patch_kernel.BLUR_COUNTER)
    trackers = []
    make = pipeline.tracker_from_settings

    def recording_tracker_from_settings(*args, **kwargs):
        trackers.append(make(*args, **kwargs))
        return trackers[-1]

    pipeline.tracker_from_settings = recording_tracker_from_settings
    if per_frame:
        loop_options = {"feature_batch_size": 0, "make_tracker": lambda: (
            pipeline.tracker_from_settings(settings, device="cuda", patch_impl=patch_impl,
                                           track_chunk_frames=0))}
    else:
        loop_options = {}
    window = _ProfileWindow(profile_window) if profile_window else None
    clock = _StepClock()
    clock.wrap(loopclosing, "start_vote_sweep", "vote sweep dispatch")
    clock.wrap(loopclosing, "detect_candidate", "vote read + candidate")
    clock.wrap(loopclosing, "relative_sim3", "sim3 fit")
    clock.wrap(posegraph, "optimize_pose_graph", "pose graph")
    clock.wrap(tracking.MonocularTracker, "_global_bundle_adjust", "global BA")
    if window is not None:
        window.hook(clock, tracking.MonocularTracker)
    stages: dict = {}
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    start = time.perf_counter()
    try:
        segments, consumed = pipeline.track_video_segments(
            frames, settings, out_dir, device="cuda", stage_seconds=stages,
            patch_impl=patch_impl, **loop_options,
        )
        torch.cuda.synchronize()
    finally:
        pipeline.tracker_from_settings = make
        clock.restore()
        if window is not None:
            window.close()
    untimed_s = untimed["seconds"] if untimed else 0.0
    seconds = time.perf_counter() - start - untimed_s
    stages["track"] -= untimed_s
    timed_frames = consumed
    if window is not None:
        profiled = window.row()
        seconds -= profiled["spent_s"]
        timed_frames -= profiled["frames"]
    launches = {c.name: c.launches for c in counters}
    plain_calls = {c.name: c.plain_cuda_calls for c in counters}
    peak = torch.cuda.max_memory_allocated()

    if consumed != len(frames_u8):
        raise AssertionError(f"{name}: consumed {consumed} of {len(frames_u8)} frames")
    if set(launches_per_frame) != set(launches):
        raise AssertionError(f"{name}: no expected launch count for some kernel of "
                             f"{sorted(launches)}")
    for kernel, a_frame in launches_per_frame.items():
        if launches[kernel] != a_frame * consumed:
            raise AssertionError(f"{name}: {kernel} launched {launches[kernel]} times, "
                                 f"want {a_frame} x {consumed} = {a_frame * consumed}")
    if any(plain_calls.values()):
        raise AssertionError(f"{name}: plain versions ran on CUDA tensors: {plain_calls}")
    if segments != 1 or len(trackers) != 1:
        raise AssertionError(f"{name}: wrote {segments} segments with {len(trackers)} "
                             "trackers, want 1")
    chunk_size = trackers[0].config.track_chunk_frames
    if (chunk_size == 0) != per_frame or (stages["chunks"] == 0) != per_frame:
        raise AssertionError(f"{name}: {stages['chunks']} chunks with track_chunk_frames "
                             f"{chunk_size}, want {'none' if per_frame else 'some'}")
    closures = trackers[0].stats["loop_closures"]
    if expect_loops != (closures > 0):
        raise AssertionError(f"{name}: {closures} loop closures, want "
                             f"{'at least 1' if expect_loops else '0'}")
    traj = read_trajectory(os.path.join(out_dir, "trajectory-0000.json"))
    tracked = len(traj)
    ok = (
        np.array_equal(traj.frame_id, np.arange(consumed))
        and np.isfinite(traj.translations).all()
        and np.isfinite(traj.rotations).all()
        and np.allclose(np.linalg.norm(traj.rotations, axis=1), 1.0, atol=1e-6)
        and traj.plane is not None and traj.plane.shape == (2, 3)
    )
    if not ok:
        raise AssertionError(
            f"{name}: trajectory-0000.json is malformed or misses frames ({tracked} of "
            f"{consumed} tracked)"
        )
    errors = trajectory_errors(traj, pose_of, period)
    print(f"{name} against the ride's true poses: {json.dumps(errors)}; "
          f"bars {json.dumps(bars)}", flush=True)
    over = {k: v for k, v in bars.items() if errors[k] > v}
    if over:
        raise AssertionError(f"{name}: trajectory off the true poses: {over}")
    loop_ms = {k: {"ms": round(ms, 2), "calls": calls}
               for k, (ms, calls) in clock.totals.items() if k != "chunk"}
    row = {"frames": consumed, "dtype": str(trackers[0].dtype).split(".")[-1],
           "seconds": seconds, "frames_per_s": timed_frames / seconds,
           "extract_ms_per_frame": 1e3 * stages["extract"] / consumed,
           "track_ms_per_frame": 1e3 * stages["track"] / consumed,
           "keyframes": len(trackers[0].keyframes), "loop_closures": closures,
           "peak_mib": peak / 2**20, "launches": launches, "against_truth": errors}
    if not per_frame:
        row.update(chunks=stages["chunks"], chunk_frames=stages["chunk_frames"],
                   frames_per_chunk=stages["chunk_frames"] / stages["chunks"],
                   refed=stages["refed"])
    if window is not None:
        row["profiled"] = profiled
    print(
        f"{name}: {segments} segment(s), {tracked} tracked of {consumed} "
        f"frames; {row['frames_per_s']:.3f} frames/s end to end "
        f"({seconds:.2f} s for {timed_frames} frames, {1e3 * untimed_s:.2f} ms of the smoke's "
        f"own work taken off"
        + (f", and the profiled window's {profiled['frames']} frames and "
           f"{profiled['spent_s']:.2f} s" if window is not None else "")
        + f"); {'extract' if per_frame else 'wait for prefetched features'} "
        f"{row['extract_ms_per_frame']:.2f} ms/frame, track "
        f"{row['track_ms_per_frame']:.2f} ms/frame"
        + (" (stage times with the profiled window in them)" if window is not None else "")
        + "; "
        f"{len(trackers[0].keyframes)} keyframes, {closures} loop closure(s); "
        f"loop closing's host time {json.dumps(loop_ms)}; "
        f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}, "
        f"plain calls on CUDA {plain_calls}",
        flush=True,
    )
    if not per_frame:
        print(f"{name}: chunks {row['chunks']}, frames consumed a chunk "
              f"{row['frames_per_chunk']:.2f}, frames re-fed {row['refed']}"
              + (f"; profiled window {json.dumps(row['profiled'])}" if window else ""),
              flush=True)
    return launches, seconds, row


# White sensor noise of a seeded make_imu_ride (standard deviations).
IMU_NOISE = {"gyro_rad_s": 0.002, "accel_m_s2": 0.02, "gps_speed_m_s": 0.05}


def make_imu_ride(duration_sec: float = 300.0, imu_hz: float = 200.0,
                  gps_hz: float = 1.0, climb_m_s: float = 0.0, seed=None):
    """A synthetic IMU + GPS ride for fit_motion, the JAX package's bench
    ride (bench.py::make_ride, rebuilt here with numpy): two IMU streams at
    ``imu_hz`` on offset grids, GPS at ``gps_hz``, a speed of 9 + 3 sin(2 pi
    t / 37) m/s and a heading of 0.6 sin(2 pi t / 23) on a level road. With
    ``climb_m_s`` the road has hills: a vertical velocity of that amplitude
    (period 17 s), which the GPS speed includes. With a ``seed`` the sensors
    have white noise (IMU_NOISE: gyro, accelerometer, GPS speed) drawn from
    it, so rides of different seeds differ; without one they are exact.
    Returns (fit_motion_arrays' six arrays, the true speed as a function of
    time in microseconds)."""
    t0 = 1_000_000

    def grid(hz, phase):
        n = int(duration_sec * hz)
        return t0 + phase + (np.arange(n) * (1e6 / hz)).astype(np.int64)

    rot_t = grid(imu_hz, 0)
    acc_t = grid(imu_hz, int(0.37 * 1e6 / imu_hz))
    gps_t = grid(gps_hz, 137)

    def sec(t):
        return (t - t0) * 1e-6

    def speed(t):
        return 9.0 + 3.0 * np.sin(2 * np.pi * t / 37.0)

    def climb(t):
        return climb_m_s * np.sin(2 * np.pi * t / 17.0)

    def heading(t):
        return 0.6 * np.sin(2 * np.pi * t / 23.0)

    def yaw(t):
        return 0.6 * (2 * np.pi / 23.0) * np.cos(2 * np.pi * t / 23.0)

    rates = np.zeros((rot_t.size, 3))
    rates[:, 2] = yaw(sec(rot_t))
    t = sec(acc_t)
    th, s, w = heading(t), speed(t), yaw(t)
    ds = 3.0 * (2 * np.pi / 37.0) * np.cos(2 * np.pi * t / 37.0)
    a_world = np.stack(
        [ds * np.cos(th) - s * np.sin(th) * w,
         ds * np.sin(th) + s * np.cos(th) * w,
         climb_m_s * (2 * np.pi / 17.0) * np.cos(2 * np.pi * t / 17.0) + 9.81],
        axis=-1,
    )
    accs = np.stack(
        [np.cos(th) * a_world[:, 0] + np.sin(th) * a_world[:, 1],
         -np.sin(th) * a_world[:, 0] + np.cos(th) * a_world[:, 1],
         a_world[:, 2]],
        axis=-1,
    )

    def true_speed(t_usec):
        return np.hypot(speed(sec(t_usec)), climb(sec(t_usec)))

    gps = true_speed(gps_t)
    if seed is not None:
        rng = np.random.default_rng(seed)
        rates = rates + rng.normal(0.0, IMU_NOISE["gyro_rad_s"], rates.shape)
        accs = accs + rng.normal(0.0, IMU_NOISE["accel_m_s2"], accs.shape)
        gps = gps + rng.normal(0.0, IMU_NOISE["gps_speed_m_s"], gps.shape)
    return (rot_t, rates, acc_t, accs, gps_t, gps), true_speed


# fit_motion: the bar on the velocity RMSE against the ride's true speed (the
# JAX bench's), and how close the card's float64 run must come to the
# port's own float64 run on the CPU. On a level road (yaw only) the
# Gauss-Newton normal equations are singular in the vertical direction, so
# rounding alone decides which nearby minimum a window settles in (the
# reference moves as much when its inputs move by 1e-15, PERF.md): there the
# bars are on the outcome. With hills every window is well conditioned and
# the two devices agree to rounding.
FIT_RMSE_BAR = 0.5
FIT_RIDES = (300.0, 1800.0)
FIT_LEVEL_BARS = {"speed_max": 0.1, "speed_median": 0.005, "rmse_gap": 0.002,
                  "forward_axis_deg": 5.0, "vertical_axis": 1e-9, "steering": 1e-9}
FIT_HILLS_BARS = {"speed_max": 1e-6, "speed_median": 1e-6, "rmse_gap": 1e-6,
                  "forward_axis_deg": 1e-4, "vertical_axis": 1e-9, "steering": 1e-9}


def _fit_distance(a, b, true_speed) -> dict:
    """How far fit_motion result ``a`` lies from ``b``: speeds at the same
    event times, the RMSEs against the true speed, the axes."""
    if not (np.array_equal(a.velocity_times_usec, b.velocity_times_usec)
            and np.array_equal(a.steering_times_usec, b.steering_times_usec)):
        raise AssertionError("fit_motion: the two runs cover different event times")
    diff = np.abs(a.velocities_m_s - b.velocities_m_s)
    truth = true_speed(a.velocity_times_usec)

    def rmse(r):
        return float(np.sqrt(np.mean((r.velocities_m_s - truth) ** 2)))

    cos = float(a.forward_axis @ b.forward_axis
                / (np.linalg.norm(a.forward_axis) * np.linalg.norm(b.forward_axis)))
    return {
        "speed_max": float(diff.max()), "speed_median": float(np.median(diff)),
        "rmse_gap": abs(rmse(a) - rmse(b)),
        "forward_axis_deg": float(np.degrees(np.arccos(min(max(cos, -1.0), 1.0)))),
        "vertical_axis": float(np.abs(a.vertical_axis - b.vertical_axis).max()),
        "steering": float(np.abs(a.steering_angular_velocities
                                 - b.steering_angular_velocities).max()),
    }


def fit_motion_stages(arrays, config) -> dict:
    """fit_motion_arrays' stage outputs, in pipeline order: the rotation-axis
    PCA's axes, the steering rates about the vertical, the host's ride
    pieces (all arrays, concatenated), the batched LM's window parameters
    and final losses, the per-event speeds before smoothing, the smoothed
    speeds and the forward axis."""
    from pilotguru_tpu_torch.calib import fit_motion

    seen = {}
    wrapped = {}

    def record(name, fn, pick):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, pick(args, out))
            return out
        wrapped[name] = fn
        return wrapper

    def as_np(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    fit_motion.principal_rotation_axes = record(
        "principal_rotation_axes", fit_motion.principal_rotation_axes,
        lambda args, out: as_np(out[0]))
    fit_motion.build_ride_pieces = record(
        "build_ride_pieces", fit_motion.build_ride_pieces,
        lambda args, out: np.concatenate([
            np.asarray(getattr(out, f), np.float64).ravel() for f in (
                "event_times_usec", "piece_end_usec", "piece_rot_rates",
                "piece_accelerations", "piece_dt_sec", "piece_gps_end_index",
                "piece_event_index", "piece_next_event_differs")]))
    fit_motion.smooth_time_series = record(
        "smooth_time_series", fit_motion.smooth_time_series,
        lambda args, out: np.asarray(args[0], np.float64))
    try:
        result = fit_motion.fit_motion_arrays(*arrays, config)
    finally:
        for name, fn in wrapped.items():
            setattr(fit_motion, name, fn)
    return {"pca_axes": seen["principal_rotation_axes"],
            "steering": result.steering_angular_velocities,
            "window_pieces": seen["build_ride_pieces"],
            "lm_window_params": result.window_params,
            "lm_final_loss": result.window_final_loss,
            "event_speeds_before_smoothing": seen["smooth_time_series"],
            "smoothed_speeds": result.velocities_m_s,
            "forward_axis": result.forward_axis}


def run_fit_motion(reps: int = 3):
    """fit_motion's path on the card: fit_motion_arrays (the library entry
    of the fit_motion CLI) on the bench's 300 s ride and on a 1,800 s drive,
    in float32 and float64, one warm-up call and ``reps`` timed calls each,
    with the kernel counts set to 0 before and read after (this path
    launches none of them). Checks each result (finite, the RMSE against the
    true speed within FIT_RMSE_BAR) and the card's float64 against the
    port's float64 on the CPU: the 300 s ride within FIT_LEVEL_BARS, and
    the same ride with hills within FIT_HILLS_BARS. Returns the rows."""
    import torch

    from pilotguru_tpu_torch.calib.fit_motion import FitMotionConfig, fit_motion_arrays
    from pilotguru_tpu_torch.utils.profiling import StageTimer

    counters = _kernel_counters()

    def config(dtype, device="cuda"):
        return FitMotionConfig(optimization_iters=30, dtype=dtype, device=device)

    def rmse(result, true_speed):
        err = result.velocities_m_s - true_speed(result.velocity_times_usec)
        return float(np.sqrt(np.mean(err ** 2)))

    rows, card = [], {}
    for duration in FIT_RIDES:
        arrays, true_speed = make_imu_ride(duration)
        for dtype in (torch.float32, torch.float64):
            fit_motion_arrays(*arrays, config(dtype))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.reset()
            seconds, timers = [], []
            for _ in range(reps):
                timers.append(StageTimer("fit_motion"))
                start = time.perf_counter()
                result = fit_motion_arrays(*arrays, config(dtype), timer=timers[-1])
                seconds.append(time.perf_counter() - start)
            launches = {c.name: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated()
            ok = (np.isfinite(result.velocities_m_s).all()
                  and result.velocities_m_s.shape == result.velocity_times_usec.shape
                  and result.velocities_m_s.size > 0.9 * 400 * duration
                  and np.isfinite(result.window_params).all())
            if not ok or any(launches.values()):
                raise AssertionError(f"fit_motion {duration:.0f} s {dtype}: malformed result "
                                     f"or kernel launches {launches}")
            error = rmse(result, true_speed)
            if not error <= FIT_RMSE_BAR:
                raise AssertionError(f"fit_motion {duration:.0f} s {dtype}: velocity RMSE "
                                     f"{error} m/s over the bar {FIT_RMSE_BAR}")
            best = timers[int(np.argmin(seconds))]
            row = {"ride_s": duration, "dtype": str(dtype).split(".")[-1],
                   "windows": int(result.window_params.shape[0]),
                   "events": int(result.velocities_m_s.size),
                   "seconds": seconds, "ride_s_per_s": [duration / t for t in seconds],
                   "stage_ms_best": {k: 1e3 * v for k, v in best.as_dict().items()},
                   "peak_device_mib": peak / 2**20, "rmse_m_s": error,
                   "max_window_loss": float(result.window_final_loss.max())}
            rows.append(row)
            print(f"fit_motion on the card: {json.dumps(row)}", flush=True)
            card[duration, dtype] = result

    short = FIT_RIDES[0]
    arrays, true_speed = make_imu_ride(short)
    start = time.perf_counter()
    cpu64 = fit_motion_arrays(*arrays, config(torch.float64, "cpu"))
    cpu_seconds = time.perf_counter() - start
    hills, hills_speed = make_imu_ride(short, climb_m_s=1.5)
    checks = (
        ("level road, card float64 against CPU float64", card[short, torch.float64], cpu64,
         true_speed, FIT_LEVEL_BARS),
        ("with hills, card float64 against CPU float64",
         fit_motion_arrays(*hills, config(torch.float64)),
         fit_motion_arrays(*hills, config(torch.float64, "cpu")), hills_speed, FIT_HILLS_BARS),
    )
    # Where the card's float64 parts from the CPU's: each stage's output, on
    # this ride and on the annotation phase's noisy one (seed 101).
    for label, ride in (("with hills", hills),
                        ("with hills and noise (seed 101)",
                         make_imu_ride(short, climb_m_s=1.5, seed=101)[0])):
        stages = {device: fit_motion_stages(ride, config(torch.float64, device))
                  for device in ("cuda", "cpu")}
        parts = {k: float(np.abs(stages["cuda"][k] - stages["cpu"][k]).max())
                 for k in stages["cpu"]}
        first = next((k for k, v in parts.items() if v > 1e-12), None)
        print(f"fit_motion {short:.0f} s ride {label}, float64, each stage's output on the "
              f"card against the CPU (largest absolute difference, in pipeline order): "
              f"{json.dumps(parts)}; first stage over 1e-12: {first}", flush=True)
    for name, a, b, speed_of, bars in checks:
        distance = _fit_distance(a, b, speed_of)
        print(f"fit_motion {short:.0f} s ride, {name}: {json.dumps(distance)}; bars "
              f"{json.dumps(bars)}", flush=True)
        over = {k: v for k, v in distance.items() if not v <= bars[k]}
        if over:
            raise AssertionError(f"fit_motion, {name}: over the bars: {over}")
    distance = _fit_distance(card[short, torch.float32], cpu64, true_speed)
    print(f"fit_motion {short:.0f} s ride, card float32 against CPU float64 (printed, no "
          f"bar): {json.dumps(distance)}; the CPU's float64 run took {cpu_seconds:.2f} s, "
          f"RMSE {rmse(cpu64, true_speed):.5f}", flush=True)
    return rows


# The seed guard: the start of the parallax ride at RANSAC seed 2, where the
# float32 tracker on the CPU loses track, at frame 13 with one thread and
# at frame 12 with eight (the thread count changes the CPU's summation
# order): a decision on a rounding-level tie (PERF.md; ROADMAP Queue 3).
# Since the card computes its two-view initialization and SVDs in float64
# (vo/twoview.py, utils/linalg.py), the card keeps track there. The phase
# reports the first lost frame on the card and, from a one-thread child
# process beside the lanes, on the CPU in float32; tests/test_torch_cuda.py
# holds the card's to ``lost_at`` (None: not lost).
SEED_GUARD = {"seed": 2, "frames": 20, "lost_at": None}


def run_seed_guard(frames_u8, device="cuda"):
    """The first SEED_GUARD["frames"] parallax frames in float32 (the card's
    geometry dtype) with the tracker's RANSAC generator at
    SEED_GUARD["seed"], until track is lost, on ``device``; on the card K1
    and K2 must run once a frame. Prints and returns the first lost frame
    (None if none)."""
    import torch

    from pilotguru_tpu_torch.vo import pipeline, tracking

    frames = frames_u8[:SEED_GUARD["frames"]]
    tracker = pipeline.tracker_from_settings(ride_settings(), device=device,
                                             dtype=torch.float32, track_chunk_frames=0)
    tracker._generator.manual_seed(SEED_GUARD["seed"])
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    states = []
    for i, gray in enumerate(frames):
        states.append(tracker.process_frame(gray, i, int(round(i * 1e6 / 30.0))))
        if states[-1] == tracking.LOST:
            break
    lost = len(states) - 1 if states[-1] == tracking.LOST else None
    launches = {c.name: c.launches for c in counters}
    print(f"seed guard (parallax ride, RANSAC seed {SEED_GUARD['seed']}, {device} "
          f"{str(tracker.dtype).split('.')[-1]}): {states.count(tracking.OK)} frames tracked "
          f"of {len(states)} run, first lost {lost} (recorded on the card: "
          f"{SEED_GUARD['lost_at']}), {len(tracker.keyframes)} keyframes; launches {launches}",
          flush=True)
    if device != "cuda":
        return lost
    want = {"fast_nms": len(states), "gather_patches": len(states), "gather_blurred_patches": 0}
    if launches != want:
        raise AssertionError(f"seed guard: launches {launches}, want {want}")
    return lost


def cpu_seed_guard_main():
    """The seed guard on the CPU in float32 (one thread); prints its first
    lost frame as one JSON line."""
    lost = run_seed_guard(list(render_ride(frames=SEED_GUARD["frames"])), device="cpu")
    print(json.dumps({"lost": lost}))


def start_cpu_seed_guard():
    """cpu_seed_guard_main in a child process with the CPU companion's
    environment, one thread: its reading is printed beside the card's."""
    env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", PYTHONPATH=REPO_DIR)
    return subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                             "chip_smoke.cpu_seed_guard_main()"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _kernel_counters():
    from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel

    return (fast_kernel.COUNTER, patch_kernel.COUNTER, patch_kernel.BLUR_COUNTER)


def _no_kernel_launches(name, counters):
    launches = {c.name: c.launches for c in counters}
    if any(launches.values()) or any(c.plain_cuda_calls for c in counters):
        raise AssertionError(f"{name}: kernel launches {launches} on a path that has none")


def _write_xyz(path, root, times, values):
    from pilotguru_tpu_torch.formats import json_io, keys

    json_io.write_json({root: [{keys.TIME_USEC: int(t), keys.X: float(v[0]),
                                keys.Y: float(v[1]), keys.Z: float(v[2])}
                               for t, v in zip(times, values)]}, path)


def write_ride_dir(ride_dir, arrays, frame_hz=None, can=False):
    """A recorder ride directory of JSON files for ``arrays``
    (make_imu_ride's six): rotations.json, accelerations.json,
    locations.json, with ``frame_hz`` a frames.json, with ``can`` a
    can_frames.json (write_can_frames)."""
    from pilotguru_tpu_torch.formats import json_io, keys

    rot_t, rates, acc_t, accs, gps_t, gps = arrays
    os.makedirs(ride_dir, exist_ok=True)
    _write_xyz(os.path.join(ride_dir, "rotations.json"), keys.ROTATIONS, rot_t, rates)
    _write_xyz(os.path.join(ride_dir, "accelerations.json"), keys.ACCELERATIONS, acc_t, accs)
    json_io.write_timestamped_values(gps_t, gps, os.path.join(ride_dir, "locations.json"),
                                     keys.LOCATIONS, keys.SPEED_M_S)
    start, end = int(max(rot_t[0], acc_t[0])), int(min(rot_t[-1], acc_t[-1]))
    if frame_hz:
        frame_t = np.arange(start, end, 1e6 / frame_hz).astype(np.int64)
        json_io.write_json({keys.FRAMES: [{keys.FRAME_ID: i, keys.TIME_USEC: int(t)}
                                          for i, t in enumerate(frame_t)]},
                           os.path.join(ride_dir, "frames.json"))
    if can:
        write_can_frames(os.path.join(ride_dir, "can_frames.json"), start, end, rot_t, rates,
                         gps_t, gps)


# Kia CAN frames of a synthetic ride: the steering wheel angle (0x2B0) and
# the four wheel speeds (0x4B0), at the rates assumed for the recorder.
CAN_RATES_HZ = {"steering_0x2b0": 100.0, "wheel_speeds_0x4b0": 50.0}


def write_can_frames(path, start_usec, end_usec, rot_t, rates, gps_t, gps):
    """can_frames.json over [start, end): 0x2B0 with the wheel angle (0.1
    degree units: 15 x the yaw rate's Ackermann angle at 2.7 m wheelbase)
    and 0x4B0 with four equal wheel speeds (0.01 km/h units), as hex text."""
    from pilotguru_tpu_torch.formats import json_io, keys

    def hex_bytes(values):
        raw = b"".join(int(v).to_bytes(2, "little", signed=True) for v in values)
        return " ".join(f"{b:02X}" for b in raw)

    frames = []
    t_steer = np.arange(start_usec, end_usec, 1e6 / CAN_RATES_HZ["steering_0x2b0"])
    speed_at = np.interp(t_steer, gps_t, gps)
    yaw = np.interp(t_steer, rot_t, rates[:, 2])
    angle = 15.0 * np.degrees(np.arctan(2.7 * yaw / np.maximum(speed_at, 1.0)))
    for t, a in zip(t_steer.astype(np.int64), np.round(angle * 10.0)):
        frames.append((int(t), "2B0 " + hex_bytes([a]) + " 00 00 00"))
    t_speed = np.arange(start_usec, end_usec, 1e6 / CAN_RATES_HZ["wheel_speeds_0x4b0"])
    kmh100 = np.round(np.interp(t_speed, gps_t, gps) * 3.6 * 100.0)
    for t, v in zip(t_speed.astype(np.int64), kmh100):
        frames.append((int(t), "4B0 " + hex_bytes([v] * 4)))
    frames.sort()
    json_io.write_json({keys.CAN_FRAMES: [{keys.TIME_USEC: t, keys.CAN_FRAME: text}
                                          for t, text in frames]}, path)


def write_synthetic_trajectory(path, frames: int):
    """A curving trajectory of ``frames`` frames at 30 fps with a stored
    plane (the goldens' trajectory generator, longer)."""
    from pilotguru_tpu_torch.formats.trajectory import Trajectory, write_trajectory

    t = np.arange(frames, dtype=np.float64)
    yaw = 0.004 * t + 0.3 * np.sin(t / 90.0)
    translations = np.stack([np.cumsum(np.cos(yaw)) * 0.1, 0.02 * np.sin(t / 50.0),
                             np.cumsum(np.sin(yaw)) * 0.1], axis=1)
    rotations = np.stack([np.cos(yaw / 2), np.zeros(frames), np.sin(yaw / 2),
                          np.zeros(frames)], axis=1)
    write_trajectory(Trajectory(
        time_usec=(1_000_000 + np.round(t * 1e6 / 30.0)).astype(np.int64),
        frame_id=np.arange(frames, dtype=np.int64), is_lost=np.zeros(frames, bool),
        translations=translations, rotations=rotations,
        plane=np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])), path)


# The corpus: bench.py's (8 rides of 300 s, two 200 Hz IMU streams, 1 Hz
# GPS, 30 Gauss-Newton iterations), each ride with its own noise seed.
CORPUS = {"rides": 8, "ride_s": 300.0, "iters": 30}


def run_corpus(reps: int = 3):
    """fit_motion_corpus on the card (float32, the CLIs' type there, and
    float64): one warm-up call, ``reps`` timed calls (ride-s/s of the best),
    peak device memory; each ride's RMSE against the true speed within
    FIT_RMSE_BAR and its result equal, bit for bit, to its own
    fit_motion_arrays result. Then preprocess_corpus over the same rides
    written as ride directories, timed with its JSON reading and writing.
    Returns (the rows, (make_imu_ride's (arrays, true speed) of each ride,
    {dtype name: the last timed call's results})) for phase 15b."""
    import torch

    from pilotguru_tpu_torch.calib.corpus import RideArrays, fit_motion_corpus
    from pilotguru_tpu_torch.calib.fit_motion import FitMotionConfig, fit_motion_arrays
    from pilotguru_tpu_torch.cli import preprocess_corpus
    from pilotguru_tpu_torch.formats import json_io, keys

    made = [make_imu_ride(CORPUS["ride_s"], seed=s) for s in range(CORPUS["rides"])]
    rides = [RideArrays(*arrays) for arrays, _ in made]
    total_s = CORPUS["ride_s"] * len(rides)
    counters = _kernel_counters()
    rows, by_dtype = [], {}
    for dtype in (torch.float32, torch.float64):
        config = FitMotionConfig(optimization_iters=CORPUS["iters"], dtype=dtype, device="cuda")
        fit_motion_corpus(rides[:1], config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        seconds = []
        for _ in range(reps):
            start = time.perf_counter()
            results = fit_motion_corpus(rides, config)
            seconds.append(time.perf_counter() - start)
        _no_kernel_launches("corpus", counters)
        peak = torch.cuda.max_memory_allocated()
        rmses = []
        for (arrays, true_speed), result in zip(made, results):
            if not np.isfinite(result.velocities_m_s).all() or result.velocities_m_s.size == 0:
                raise AssertionError(f"corpus {dtype}: malformed result")
            err = result.velocities_m_s - true_speed(result.velocity_times_usec)
            rmses.append(float(np.sqrt(np.mean(err ** 2))))
            single = fit_motion_arrays(*arrays, config)
            for field in ("vertical_axis", "steering_angular_velocities", "velocity_times_usec",
                          "velocities_m_s", "forward_axis", "window_params",
                          "window_final_loss"):
                if not np.array_equal(getattr(result, field), getattr(single, field)):
                    raise AssertionError(f"corpus {dtype}: {field} differs from the ride's "
                                         "own fit_motion_arrays")
        if not max(rmses) <= FIT_RMSE_BAR:
            raise AssertionError(f"corpus {dtype}: RMSE {max(rmses)} over {FIT_RMSE_BAR}")
        row = {"rides": len(rides), "ride_s": CORPUS["ride_s"],
               "dtype": str(dtype).split(".")[-1], "seconds": seconds,
               "ride_s_per_s": [total_s / t for t in seconds],
               "best_ride_s_per_s": total_s / min(seconds), "peak_device_mib": peak / 2**20,
               "rmse_m_s": rmses, "equal_to_per_ride": True}
        rows.append(row)
        by_dtype[row["dtype"]] = results
        print(f"corpus on the card: {json.dumps(row)}", flush=True)

    root = tempfile.mkdtemp(prefix="pg_corpus_")
    try:
        start = time.perf_counter()
        for i, (arrays, _) in enumerate(made):
            write_ride_dir(os.path.join(root, f"ride-{i:02d}"), arrays)
        written = time.perf_counter() - start
        for c in counters:
            c.reset()
        start = time.perf_counter()
        with _platform("cuda"):
            preprocess_corpus.main([f"--corpus_dir={root}",
                                    f"--optimization_iters={CORPUS['iters']}"])
        cli_seconds = time.perf_counter() - start
        _no_kernel_launches("preprocess_corpus", counters)
        rmses = []
        for i, (_, true_speed) in enumerate(made):
            times, speeds = json_io.read_timestamped_values(
                os.path.join(root, f"ride-{i:02d}", "postprocessed", "velocities-imu.json"),
                keys.VELOCITIES, keys.SPEED_M_S)
            rmses.append(float(np.sqrt(np.mean((speeds - true_speed(times)) ** 2))))
        if not max(rmses) <= FIT_RMSE_BAR:
            raise AssertionError(f"preprocess_corpus: RMSE {max(rmses)} over {FIT_RMSE_BAR}")
        row = {"cli": "preprocess_corpus", "rides": len(made), "seconds": cli_seconds,
               "ride_s_per_s": total_s / cli_seconds, "inputs_written_s": written,
               "rmse_m_s": rmses}
        rows.append(row)
        print(f"preprocess_corpus on the card (JSON in and out included): {json.dumps(row)}",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows, (made, by_dtype)


@contextlib.contextmanager
def _platform(device: str):
    """PILOTGURU_TPU_PLATFORM, which the port's CLIs read, set to ``device``."""
    saved = os.environ.get("PILOTGURU_TPU_PLATFORM")
    os.environ["PILOTGURU_TPU_PLATFORM"] = device
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PILOTGURU_TPU_PLATFORM", None)
        else:
            os.environ["PILOTGURU_TPU_PLATFORM"] = saved


def _run_cli(times, name, main, argv):
    start = time.perf_counter()
    if main(argv) != 0:
        raise AssertionError(f"{name}: non-zero exit")
    times[name] = time.perf_counter() - start


def annotate_ride(ride_dir, out_dir, trajectories, dtype_flag=None, wrapper=True):
    """The ride-annotation CLIs in-process, in order, each timed: fit_motion
    and process_can_frames (through preprocess_all when ``wrapper``, which
    runs them as they are, or directly with ``dtype_flag``),
    interpolate_velocity (--l1_weight=1, its 1,000 iterations),
    integrate_motion, annotate_frames on velocities-imu.json and on
    steering-imu.json (smoothed, sigma 0.1 s), then smooth_heading_directions
    (--sigma=2) and project_translations on each of ``trajectories``.
    ``dtype_flag``: the --dtype of the CLIs that take one (None: auto).
    Returns the wall seconds by CLI."""
    from pilotguru_tpu_torch.cli import (
        annotate_frames,
        fit_motion,
        integrate_motion,
        interpolate_velocity,
        preprocess_all,
        process_can_frames,
        project_translations,
        smooth_heading_directions,
    )

    os.makedirs(out_dir, exist_ok=True)
    dt = [f"--dtype={dtype_flag}"] if dtype_flag else []

    def r(name):
        return os.path.join(ride_dir, name)

    def o(name):
        return os.path.join(out_dir, name)

    times = {}
    if wrapper:
        _run_cli(times, "preprocess_all", preprocess_all.main,
                 [f"--in_dir={ride_dir}", f"--out_dir={out_dir}", "--process_can_data=true"])
    else:
        _run_cli(times, "fit_motion", fit_motion.main, [
            f"--rotations_json={r('rotations.json')}",
            f"--accelerations_json={r('accelerations.json')}",
            f"--locations_json={r('locations.json')}",
            f"--velocities_out_json={o('velocities-imu.json')}",
            f"--steering_out_json={o('steering-imu.json')}",
            f"--forward_axis_out_json={o('forward.json')}"] + dt)
        _run_cli(times, "process_can_frames", process_can_frames.main, [
            f"--can_frames_json={r('can_frames.json')}",
            f"--velocities_out_json={o('velocities-can.json')}",
            f"--steering_out_json={o('steering-can.json')}"])
    _run_cli(times, "interpolate_velocity", interpolate_velocity.main, [
        f"--locations_json={r('locations.json')}", f"--frames_json={r('frames.json')}",
        f"--out_json={o('interpolated.json')}", "--l1_weight=1"] + dt)
    _run_cli(times, "integrate_motion", integrate_motion.main, [
        f"--rotations_json={r('rotations.json')}",
        f"--accelerations_json={r('accelerations.json')}",
        f"--out_json={o('integrated.json')}"] + dt)
    _run_cli(times, "annotate_frames velocities", annotate_frames.main, [
        f"--frames_json={r('frames.json')}", f"--in_json={o('velocities-imu.json')}",
        "--json_root_element_name=velocities", "--json_value_name=speed_m_s",
        f"--out_json={o('frames-velocities.json')}"] + dt)
    _run_cli(times, "annotate_frames steering", annotate_frames.main, [
        f"--frames_json={r('frames.json')}", f"--in_json={o('steering-imu.json')}",
        "--json_root_element_name=steering", "--json_value_name=angular_velocity",
        "--smoothing_sigma=0.1", f"--out_json={o('frames-steering.json')}"] + dt)
    for label, path in trajectories.items():
        _run_cli(times, f"smooth_heading_directions {label}", smooth_heading_directions.main, [
            f"--trajectory_in_file={path}", "--sigma=2",
            f"--trajectory_out_file={o(f'smoothed-{label}.json')}"] + dt)
        _run_cli(times, f"project_translations {label}", project_translations.main, [
            f"--trajectory_in_file={path}",
            f"--trajectory_out_file={o(f'projected-{label}.json')}"])
    return times


# Files annotate_ride writes: float series (root, value) compared between
# runs, and files of host-only CLIs, which must match to the byte.
ANNOTATION_SERIES = {
    "velocities-imu.json": ("velocities", "speed_m_s"),
    "steering-imu.json": ("steering", "angular_velocity"),
    "interpolated.json": ("frames", "speed_m_s"),
    "integrated.json": ("frames", "speed_m_s"),
    "frames-velocities.json": ("velocities", "speed_m_s"),
    "frames-steering.json": ("steering", "angular_velocity"),
}
HOST_ONLY_FILES = ("velocities-can.json", "steering-can.json")

# The 300 s ride with hills, each float output of the card's runs against
# the port's float64 run on the CPU (largest absolute difference, in the
# output's unit: m/s, rad/s, or the trajectory's unit-quaternion and
# direction components). Float64: rounding, 1e-9, except fit_motion's
# speeds and axis, which its converged solve carries from reductions summed
# in another order (1.8e-8 m/s and 5.7e-10 read on the card with sensor
# noise, 4.5e-9 without; FIT_HILLS_BARS allows 1e-6). Float32: set from the
# card's readings (PERF.md).
ANNOTATION_BARS = {
    "float64": {**{name: 1e-9 for name in list(ANNOTATION_SERIES) + ["smoothed"]},
                "velocities-imu.json": 1e-7, "frames-velocities.json": 1e-7,
                "forward.json": 1e-8},
    # Read on the H100: 0.0326, 1.5e-8, 2.0000007 (two of
    # interpolate_velocity's clipped 1 m/s steps), 0.0358, 0.0326, 3.9e-6,
    # 1.9e-4, 5.5e-7. integrate_motion's 0.0358 came from CUDA's float32
    # cumsum of the velocities (integrate_stages.py); summed in XLA's
    # blocked order it reads 0.0031528 and is held to twice the JAX
    # package's own float32 distance on the CPU (0.00316).
    "float32": {"velocities-imu.json": 0.1, "steering-imu.json": 1e-7,
                "interpolated.json": 3.0, "integrated.json": 0.0063,
                "frames-velocities.json": 0.1, "frames-steering.json": 1e-5,
                "forward.json": 1e-3, "smoothed": 1e-6},
}


def _annotation_distance(a_dir, b_dir, labels) -> dict:
    from pilotguru_tpu_torch.formats import json_io, keys
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory

    out = {}
    for name, (root, value) in ANNOTATION_SERIES.items():
        ea = json_io.read_json(os.path.join(a_dir, name))[root]
        eb = json_io.read_json(os.path.join(b_dir, name))[root]
        ka = [e.get(keys.TIME_USEC, e.get(keys.FRAME_ID)) for e in ea]
        kb = [e.get(keys.TIME_USEC, e.get(keys.FRAME_ID)) for e in eb]
        if ka != kb:
            raise AssertionError(f"{name}: the runs cover different times or frames")
        out[name] = float(np.max(np.abs(np.asarray([e[value] for e in ea])
                                        - np.asarray([e[value] for e in eb]))))
    fa = json_io.read_forward_axis(os.path.join(a_dir, "forward.json"))
    fb = json_io.read_forward_axis(os.path.join(b_dir, "forward.json"))
    out["forward.json"] = float(np.abs(fa - fb).max())
    smoothed = 0.0
    for label in labels:
        ta = read_trajectory(os.path.join(a_dir, f"smoothed-{label}.json"))
        tb = read_trajectory(os.path.join(b_dir, f"smoothed-{label}.json"))
        for field in ("rotations", "planar_directions", "turn_angles"):
            smoothed = max(smoothed, float(np.abs(getattr(ta, field)
                                                  - getattr(tb, field)).max()))
    out["smoothed"] = smoothed
    for name in HOST_ONLY_FILES + tuple(f"projected-{label}.json" for label in labels):
        with open(os.path.join(a_dir, name), "rb") as fa_, open(os.path.join(b_dir, name),
                                                                 "rb") as fb_:
            if fa_.read() != fb_.read():
                raise AssertionError(f"{name}: host-only output differs between the runs")
    return out


# interpolate_velocity's speeds against the true speed (m/s), over the
# frames between the first and the last GPS fix. With --l1_weight=1 and
# the reference's constant learning rate of 0.1 and clip of 10, each
# frame's speed keeps stepping by up to 1 m/s around the optimum (the JAX
# package gives the same speeds to the bit, tests/test_torch_data_clis.py:
# RMSE 0.92 on the 300 s ride), so the frames are held to 1 m/s and their
# means over each GPS interval, which the objective matches, to 0.5.
INTERPOLATION_BARS = {"frame_rmse": 1.0, "interval_rmse": 0.5}


def interpolation_errors(frame_t, speeds, gps_t, true_speed) -> dict:
    """RMSEs of interpolated frame speeds against the true speed: per frame,
    and of the means over each GPS interval, for frames inside the GPS
    fixes' span."""
    k = np.searchsorted(gps_t, frame_t, side="right") - 1
    inside = (k >= 0) & (k < len(gps_t) - 1) & (frame_t > gps_t[0])
    err = speeds[inside] - true_speed(frame_t[inside])
    counts = np.bincount(k[inside], minlength=len(gps_t) - 1)
    mean_err = np.bincount(k[inside], err, minlength=len(gps_t) - 1)[counts > 0] \
        / counts[counts > 0]
    return {"frame_rmse": float(np.sqrt(np.mean(err ** 2))),
            "interval_rmse": float(np.sqrt(np.mean(mean_err ** 2)))}


# The ride annotated end to end: a 1,800 s drive, frames at 30 fps.
ANNOTATION_RIDE = {"ride_s": 1800.0, "frame_hz": 30.0, "compare_ride_s": 300.0}


def run_annotation(parallax_trajectory):
    """The ride-annotation CLIs on the card. First the 1,800 s drive (54,000
    frame times, a Kia CAN log over the whole ride), through preprocess_all
    and the rest of annotate_ride, each CLI timed, the kernel counts set to
    0 before and read after (this path launches none): the interpolated
    speeds within INTERPOLATION_BARS of the true speed. Then the 300 s ride
    with hills run three ways, the card in float32 and float64 and the CPU
    in float64, each CLI called directly: every float output of the card's
    runs within ANNOTATION_BARS of the CPU's, and the host-only outputs (CAN,
    projected translations) identical to the byte. Returns the rows."""
    from pilotguru_tpu_torch.formats import json_io, keys

    root = tempfile.mkdtemp(prefix="pg_annotate_")
    counters = _kernel_counters()
    rows = []
    try:
        ride_s, frame_hz = ANNOTATION_RIDE["ride_s"], ANNOTATION_RIDE["frame_hz"]
        arrays, true_speed = make_imu_ride(ride_s, seed=100)
        ride_dir = os.path.join(root, "ride")
        start = time.perf_counter()
        write_ride_dir(ride_dir, arrays, frame_hz=frame_hz, can=True)
        synthetic = os.path.join(root, "trajectory-54000.json")
        write_synthetic_trajectory(synthetic, int(ride_s * frame_hz))
        written = time.perf_counter() - start
        trajectories = {"parallax": parallax_trajectory, "synthetic": synthetic}
        for c in counters:
            c.reset()
        with _platform("cuda"):
            times = annotate_ride(ride_dir, os.path.join(ride_dir, "postprocessed"),
                                  trajectories)
        _no_kernel_launches("ride annotation", counters)
        frames = json_io.read_json(os.path.join(ride_dir, "postprocessed",
                                                "interpolated.json"))[keys.FRAMES]
        speeds = np.asarray([f[keys.SPEED_M_S] for f in frames])
        frame_t = np.asarray([f[keys.TIME_USEC] for f in frames])
        errors = interpolation_errors(frame_t, speeds, arrays[4], true_speed)
        row = {"ride_s": ride_s, "frames": len(frames), "cli_seconds": times,
               "total_seconds": sum(times.values()), "inputs_written_s": written,
               "interpolated": errors, "interpolated_bars": INTERPOLATION_BARS}
        rows.append(row)
        print(f"ride annotation on the card, {ride_s:.0f} s ride, float32: {json.dumps(row)}",
              flush=True)
        if len(frames) < 0.999 * ride_s * frame_hz or not np.isfinite(speeds).all():
            raise AssertionError(f"ride annotation: {len(frames)} interpolated frames")
        over = {k: v for k, v in errors.items() if not v <= INTERPOLATION_BARS[k]}
        if over:
            raise AssertionError(f"ride annotation: interpolated speeds over the bars: {over}")

        short = ANNOTATION_RIDE["compare_ride_s"]
        arrays, _ = make_imu_ride(short, climb_m_s=1.5, seed=101)
        ride_dir = os.path.join(root, "hills")
        write_ride_dir(ride_dir, arrays, frame_hz=frame_hz, can=True)
        synthetic = os.path.join(root, "trajectory-9000.json")
        write_synthetic_trajectory(synthetic, int(short * frame_hz))
        trajectories = {"parallax": parallax_trajectory, "synthetic": synthetic}
        runs = {}
        for label, platform, dtype_flag in (("card float32", "cuda", "float32"),
                                            ("card float64", "cuda", "float64"),
                                            ("cpu float64", "cpu", "float64")):
            out = os.path.join(root, label.replace(" ", "-"))
            runs[label] = out
            with _platform(platform):
                times = annotate_ride(ride_dir, out, trajectories, dtype_flag, wrapper=False)
            print(f"ride annotation, {short:.0f} s ride with hills, {label}: "
                  f"{json.dumps(times)}", flush=True)
        over = {}
        for label, dtype_name in (("card float64", "float64"), ("card float32", "float32")):
            distance = _annotation_distance(runs[label], runs["cpu float64"], trajectories)
            bars = ANNOTATION_BARS[dtype_name]
            row = {"compare": f"{label} against cpu float64", "ride_s": short,
                   "max_abs": distance, "bars": bars}
            rows.append(row)
            print(f"ride annotation, {short:.0f} s ride with hills: {json.dumps(row)}",
                  flush=True)
            over.update({f"{label}: {k}": v for k, v in distance.items() if not v <= bars[k]})
        if over:
            raise AssertionError(f"ride annotation: over the bars: {over}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


PARALLAX_LAUNCHES = {"fast_nms": 1, "gather_patches": 1, "gather_blurred_patches": 0}
LOOP_LAUNCHES = {"fast_nms": 1, "gather_patches": 0, "gather_blurred_patches": 1}
# 7c: frames of the parallax ride whose chunks run under torch.profiler
# (reading its events back takes about 3 s a frame on the card's host).
CHUNKED_PROFILE_WINDOW = (60, 68)


def run_default_parallax(ride, out_dir, parallax_row) -> dict:
    """7c, the parallax ride: the segment loop at its defaults, the CLI's
    configuration (frames decoded on a thread, features prefetched in
    batches of 8 on a worker thread, chunks of 16 tracked through
    keyframes), with run_path's checks: one segment and one tracker, each
    kernel once a frame, no plain version on a CUDA tensor, no loop closed,
    TRUTH_BARS. Runs alone on the card, as phase 7 does, and prints its
    frames/s beside phase 7's. Returns the row with its trajectory's path."""
    row = run_path(
        "parallax path, chunked with prefetch", ride, os.path.join(out_dir, "parallax_chunked"),
        "blur_then_gather", PARALLAX_LAUNCHES, ride_pose, TRUTH_BARS, per_frame=False,
        profile_window=CHUNKED_PROFILE_WINDOW)[2]
    row["trajectory"] = os.path.join(out_dir, "parallax_chunked", "trajectory-0000.json")
    print_default_against_per_frame("parallax", row, parallax_row, 7, "alone on the card")
    return row


def run_default_loop(loop_ride, out_dir):
    """7c, the loop ride: the segment loop at its defaults, the CLI's on the
    card (float32; fused: K1 and K3 through the prefetcher), run_path's
    checks, at least one loop closed, LOOP_TRUTH_BARS. Returns run_path's
    result."""
    return run_path(
        "loop ride, chunked with prefetch", loop_ride, os.path.join(out_dir, "loop_chunked"),
        "fused", LOOP_LAUNCHES, loop_pose, LOOP_TRUTH_BARS, period=LOOP_PERIOD,
        expect_loops=True, per_frame=False)


def print_default_against_per_frame(name, chunked, per_frame, phase, how):
    print(f"7c {name}: chunked with prefetch {chunked['frames_per_s']:.3f} frames/s "
          f"({chunked['dtype']}), frame by frame {per_frame['frames_per_s']:.3f} "
          f"({per_frame['dtype']}; phase {phase}, this call; {how}); peak device memory "
          f"{chunked['peak_mib']:.1f} against {per_frame['peak_mib']:.1f} MiB", flush=True)


# ---------------------------------------------------------------------------
# Lanes: once phases 7 and 7c's parallax ride have had the card alone, the
# phases that need nothing of each other run at once, each group in a
# process of its own (the card is more than 90% idle under each VO path,
# whose host launches bound it; PERF.md §5). Each lane's phases keep their
# own checks, kernel counts and bars; the times they print are taken
# beside the other lanes.

def _lane_main(send, fn, args, kwargs):
    import traceback

    os.setpgrp()  # Lane.stop ends the lane's own children with it
    try:
        import pilotguru_tpu_torch  # noqa: F401  (precision policy)

        result = ("ok", fn(*args, **kwargs))
    except BaseException:  # the parent raises it again
        result = ("failed", traceback.format_exc())
    send.send(result)
    send.close()


class Lane:
    """``fn(*args, **kwargs)``, a function of this module, in a spawned
    process from now on; ``result()`` waits for its return value and
    raises if it raised; ``stop()`` ends the process if it still runs."""

    def __init__(self, name, fn, *args, **kwargs):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.name = name
        self._recv, send = ctx.Pipe(duplex=False)
        self.started = time.perf_counter()
        self.process = ctx.Process(target=_lane_main, args=(send, fn, args, kwargs),
                                   name=name)
        self.process.start()
        send.close()

    def result(self):
        try:
            status, value = self._recv.recv()
        except EOFError:
            self.process.join()
            raise AssertionError(f"lane {self.name}: its process ended (exit code "
                                 f"{self.process.exitcode}) without a result") from None
        self.process.join()
        print(f"-- lane {self.name} took {time.perf_counter() - self.started:.1f} s",
              flush=True)
        if status != "ok":
            raise AssertionError(f"lane {self.name} failed:\n{value}")
        return value

    def stop(self):
        import signal

        for sig in (signal.SIGTERM, signal.SIGKILL):
            try:
                os.killpg(self.process.pid, sig)
            except ProcessLookupError:
                break
            self.process.join(30)


def run_cli_lane(ride, out_dir, phase7c_trajectory, phase7c_frames_per_s, decoder):
    """The VO CLI on the image list, the golden mp4 frame by frame (where a
    decoder exists), then the tracker's image entry (run_process_frame).
    Returns (run_vo_cli_image_list's row, run_golden_cli's (row, path) or
    None, run_process_frame's launches)."""
    vo_cli = run_vo_cli_image_list(ride, os.path.join(out_dir, "vo_cli"), phase7c_trajectory,
                                   phase7c_frames_per_s)
    per_frame = None
    if decoder:
        per_frame = run_golden_cli(os.path.join(out_dir, "golden_card_per_frame"),
                                   per_frame=True)
    return vo_cli, per_frame, run_process_frame(ride)


# 9b: the parallax frames the tracker's image entry runs over.
PROCESS_FRAME_FRAMES = 40


def run_process_frame(frames_u8):
    """9b, the tracker's image entry: the first PROCESS_FRAME_FRAMES
    parallax frames through MonocularTracker.process_frame with
    ``feature_fn=None`` (the tracker's own extractor on the card), frame by
    frame at 2000 features / 8 levels, blur-then-gather, the kernel counts
    set to 0 just before and read just after: K1 and K2 once a frame, K3
    never, no plain version on a CUDA tensor. Beside it a tracker fed the
    same frames through ``features`` and ``process_features`` at the same
    RANSAC seed: every state, map point and pose equal to the bit. Returns
    the launch counts."""
    import torch

    from pilotguru_tpu_torch.vo import pipeline

    frames = frames_u8[:PROCESS_FRAME_FRAMES]
    times = [int(round(i * 1e6 / 30.0)) for i in range(len(frames))]

    def tracker():
        return pipeline.tracker_from_settings(ride_settings(), device="cuda",
                                              track_chunk_frames=0)

    fed = tracker()
    fed_states = []
    for i, gray in enumerate(frames):
        feats = fed.features(gray)
        fed_states.append(fed.process_features(*feats[:3], i, times[i], *feats[3:]))
    counters = _kernel_counters()
    entry = tracker()
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    start = time.perf_counter()
    states = [entry.process_frame(gray, i, times[i]) for i, gray in enumerate(frames)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {c.name: c.launches for c in counters}
    plain_calls = {c.name: c.plain_cuda_calls for c in counters}
    poses = [fp.pose6 for fp in entry.final_trajectory()]
    fed_poses = [fp.pose6 for fp in fed.final_trajectory()]
    equal = (states == fed_states and len(poses) == len(fed_poses)
             and all(np.array_equal(a, b) for a, b in zip(poses, fed_poses))
             and np.array_equal(entry.points, fed.points)
             and np.array_equal(entry.point_valid, fed.point_valid))
    row = {"frames": len(frames), "seconds": seconds, "frames_per_s": len(frames) / seconds,
           "tracked": states.count("OK"), "keyframes": len(entry.keyframes),
           "launches": launches, "plain_calls": plain_calls,
           "equal_to_process_features": equal}
    print(f"9b: the tracker's image entry (process_frame, feature_fn=None) on the first "
          f"{len(frames)} parallax frames: {json.dumps(row)}", flush=True)
    want = {"fast_nms": len(frames), "gather_patches": len(frames), "gather_blurred_patches": 0}
    if launches != want or any(plain_calls.values()) or not equal:
        raise AssertionError(f"9b: launches {launches} (want {want}), plain calls "
                             f"{plain_calls}, equal to process_features: {equal}")
    return launches


def run_golden_lane(out_dir):
    """The golden mp4 through the VO CLI at its defaults (phase 10), its
    features saved; the port's CPU tracker replays them in a child process
    (start_golden_replay) while the visualization (12i) runs against the
    card's run; then the card's run against the replay
    (check_golden_replay). Returns (run_golden_cli's row,
    run_visualize's (launches, row))."""
    features = os.path.join(out_dir, "golden_features.npz")
    golden, path = run_golden_cli(os.path.join(out_dir, "golden_card"), features_to=features)
    replay_dir = os.path.join(out_dir, "golden_replay")
    replay = start_golden_replay(features, replay_dir)
    try:
        visualized = run_visualize(os.path.join(out_dir, "visualize"), path)
        check_golden_replay(golden, path, replay_dir, finish_cpu_companion(replay))
    finally:
        if replay.poll() is None:
            replay.kill()
            replay.communicate()
    return golden, visualized


def run_host_lane(parallax_trajectory, ride):
    """Phases 13 to 15b: fit_motion, the corpus, the ride annotation and the
    sharded paths. Returns run_sharded_paths' launches."""
    run_fit_motion()
    _, corpus = run_corpus()
    run_annotation(parallax_trajectory)
    return run_sharded_paths(ride, corpus)


# ---------------------------------------------------------------------------
# Phase 15b: the paths the JAX package spreads over every device, each run
# over sharded_devices() against its one-device run: the corpus's windows
# (preprocess_corpus --shard_windows), the prefetched features (the VO
# CLI's default), the search's super-ensemble (hyperparams_search), and the
# profiler hook of the fit_motion CLI.

# The search group of phase 15b: two folds of one PilotNet each (nets split
# one a device over two devices), on synthetic 66x200 frames from a numpy
# seed, one epoch at batch 64.
SHARDED_SEARCH = {"examples": 256, "val_examples": 64, "batch": 64, "lr": 1e-3}
# The group sharded against unsharded: per-net losses (relative) and the
# last checkpoints' parameters and batch statistics (absolute). Not to the
# bit: the folded batch norm's channel reductions (and cuDNN's grouped
# convolutions) change with the nets a device holds. About 4 times the
# first reading on an H100 (PERF.md): 1.16e-6 and 1.23e-5.
SHARDED_SEARCH_BARS = {"loss_rel": 5e-6, "param_abs": 5e-5}


def sharded_devices():
    """Every visible card, or cuda:0 twice where only one is visible: the
    list then shows the split, the streams, each shard's launches and the
    gather on one card (not copies between cards, nor their concurrency)."""
    from pilotguru_tpu_torch.parallel.mesh import cuda_devices

    cards = cuda_devices()
    return cards if len(cards) > 1 else cards * 2


# The corpus over a mesh against phase 14's unsharded run. The windows'
# solve and replay run per block, and on the card three of their
# operations change their bits with the number of windows in a call
# (corpus_shard_ops.py, PERF.md): cuBLAS's batched products of small
# matrices (the gyro-rotated accelerations r_pre @ a, the affine travel's
# and its Jacobian's broadcast products, float32) and CUDA's cumsum along
# the innermost axis (the pieces' cumulative time). On these level rides
# rounding decides the window's minimum (FIT_LEVEL_BARS' comment), so the
# speeds and the forward axis are held to FIT_LEVEL_BARS, the smoke's bars
# for two runs that differ in rounding; what comes before the windows
# (vertical axis, steering, event times) must be equal to the bit. The
# largest differences are printed beside ANNOTATION_BARS'.
SHARDED_CORPUS_EXACT = ("vertical_axis", "steering_angular_velocities",
                        "velocity_times_usec", "steering_times_usec")


def run_sharded_corpus(corpus, devices) -> dict:
    """(a) fit_motion_corpus over a ("windows",) mesh of ``devices`` on
    run_corpus's rides in float32 and float64, against run_corpus's
    unsharded results: every field's largest difference, whether all are
    equal to the bit, each ride within FIT_LEVEL_BARS and equal to the bit
    in SHARDED_CORPUS_EXACT."""
    import torch

    from pilotguru_tpu_torch.calib.corpus import RideArrays, fit_motion_corpus
    from pilotguru_tpu_torch.calib.fit_motion import FitMotionConfig
    from pilotguru_tpu_torch.parallel.mesh import make_mesh

    made, unsharded = corpus
    rides = [RideArrays(*arrays) for arrays, _ in made]
    mesh = make_mesh(("windows",), (len(devices),), devices)
    row = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        config = FitMotionConfig(optimization_iters=CORPUS["iters"], dtype=dtype, device="cuda")
        start = time.perf_counter()
        sharded = fit_motion_corpus(rides, config, mesh=mesh)
        seconds = time.perf_counter() - start
        worst, level = {}, {}
        for (_, true_speed), s, u in zip(made, sharded, unsharded[name]):
            for field in SHARDED_CORPUS_EXACT:
                if not np.array_equal(getattr(s, field), getattr(u, field)):
                    raise AssertionError(f"sharded corpus {name}: {field} differs")
            for field in ("velocities_m_s", "forward_axis", "window_params",
                          "window_final_loss"):
                d = float(np.abs(getattr(s, field) - getattr(u, field)).max())
                worst[field] = max(worst.get(field, 0.0), d)
            for key, d in _fit_distance(s, u, true_speed).items():
                level[key] = max(level.get(key, 0.0), d)
        row[name] = {"seconds": seconds, "max_abs_difference": worst,
                     "equal": all(d == 0.0 for d in worst.values()),
                     "fit_distance": level, "bars": FIT_LEVEL_BARS,
                     "annotation_bars": {k: ANNOTATION_BARS[name][k]
                                         for k in ("velocities-imu.json", "forward.json")}}
        over = {k: v for k, v in level.items() if not v <= FIT_LEVEL_BARS[k]}
        if over:
            raise AssertionError(f"sharded corpus {name}: over FIT_LEVEL_BARS {over}: "
                                 f"{json.dumps(row[name])}")
    return row


def run_sharded_prefetch(frames_u8, devices, batch=8) -> dict:
    """(b) prefetch_features over ``devices`` on the parallax ride's frames
    at 2000 features / 8 levels, against the one-device prefetcher: every
    feature and device row equal to the bit, frames in order, and the
    sharded run's launches (counts set to 0 just before it): K1 and K2 once
    a frame, K3 never, no plain call on the card."""
    import torch

    from pilotguru_tpu_torch.vo.pipeline import VideoFrame, camera_and_config, prefetch_features

    camera, config = camera_and_config(ride_settings())
    counters = _kernel_counters()

    def run(on):
        frames = (VideoFrame(g, i, 1_000_000 + i * 33_333) for i, g in enumerate(frames_u8))
        return list(prefetch_features(frames, camera, config, batch, on))

    one = run(devices[0])
    for c in counters:
        c.reset()
    start = time.perf_counter()
    sharded = run(devices)
    seconds = time.perf_counter() - start
    launches = {c.name: c.launches for c in counters}
    if any(c.plain_cuda_calls for c in counters):
        raise AssertionError("sharded prefetch: a plain version ran on the card")
    want = {"fast_nms": len(frames_u8), "gather_patches": len(frames_u8),
            "gather_blurred_patches": 0}
    if launches != want:
        raise AssertionError(f"sharded prefetch: launches {launches}, want {want}")
    if [f.frame_id for f in sharded] != list(range(len(frames_u8))):
        raise AssertionError("sharded prefetch: frames out of order")
    for a, b in zip(sharded, one):
        same = all(np.array_equal(np.asarray(x.cpu() if torch.is_tensor(x) else x),
                                  np.asarray(y.cpu() if torch.is_tensor(y) else y))
                   for x, y in zip(a.features, b.features))
        same = same and all(x.device == y.device and torch.equal(x, y)
                            for x, y in zip(a.dev_features, b.dev_features))
        if not same:
            raise AssertionError(f"sharded prefetch: frame {a.frame_id} differs from the "
                                 "one-device prefetcher")
    return {"frames": len(frames_u8), "batch": batch, "seconds": seconds,
            "frames_per_s": len(frames_u8) / seconds, "launches": launches, "equal": True}


def _search_data(rng, n):
    return {"frame_img": rng.integers(0, 256, (n, 66, 200, 3), dtype=np.uint8),
            "forward_axis": rng.normal(0, 1, (n, 3)).astype(np.float32),
            "steering": rng.normal(0, 0.3, (n, 2)).astype(np.float32)}


def run_sharded_search(devices, root) -> dict:
    """(c) one hyperparams_search group of two folds (one PilotNet each,
    learning rates 1e-3 and 5e-4, augmentation and dropout on) for one
    epoch, its nets split over ``devices`` against the same group on the
    first device: per-net losses and the last checkpoints' parameters
    within SHARDED_SEARCH_BARS."""
    from pilotguru_tpu_torch.cli import hyperparams_search
    from pilotguru_tpu_torch.ml import training

    rng = np.random.default_rng(7)
    train = _search_data(rng, SHARDED_SEARCH["examples"])
    val = _search_data(rng, SHARDED_SEARCH["val_examples"])
    base = {"input_names": ["frame_img", "forward_axis"], "label_names": ["steering"],
            "net_name": "nvidia", "target_height": 66, "target_width": 200,
            "label_dimensions": 2, "optimizer": "sgd", "batch_size": SHARDED_SEARCH["batch"],
            "linear_bias_options": [{"input_name": "forward_axis", "input_dims": 3}],
            "compute_dtype": "float32", "dropout_prob": 0.2,
            "max_horizontal_shift_pixels": 0, "train_blur_prob": 0.5,
            "grayscale_interpolate_prob": 0.2}
    folds = [dict(base, learning_rate=SHARDED_SEARCH["lr"], settings_id="lr-a"),
             dict(base, learning_rate=SHARDED_SEARCH["lr"] / 2, settings_id="lr-b")]
    runs = {}
    for tag, on in (("one", None), ("sharded", devices)):
        start = time.perf_counter()
        hyperparams_search.run_training_group(
            folds, train, val, epochs=1, num_nets=1, batch_use_prob=1.0,
            out_root=os.path.join(root, tag, "out"), log_root=os.path.join(root, tag, "log"),
            device=devices[0], devices=on)
        logs = {f["settings_id"]: _train_log(os.path.join(root, tag, "log", f["settings_id"]))
                for f in folds}
        nets = {f["settings_id"]: _flat_tree(training.load_net(os.path.join(
            root, tag, "out", f["settings_id"], "model-0-last.msgpack"))) for f in folds}
        runs[tag] = (time.perf_counter() - start, logs, nets)
    (one_s, one_logs, one_nets), (sharded_s, sharded_logs, sharded_nets) = runs.values()
    loss_rel, param_abs = 0.0, 0.0
    for sid in one_logs:
        for a, b in zip(sharded_logs[sid], one_logs[sid]):
            for key in ("train_loss_per_net", "val_loss_per_net"):
                x, y = np.asarray(a[key]), np.asarray(b[key])
                if not (np.isfinite(x).all() and x.shape == y.shape == (1,)):
                    raise AssertionError(f"sharded search: {sid} {key} malformed: {x}")
                loss_rel = max(loss_rel, float(np.max(np.abs(x - y) / np.abs(y))))
        for name, value in one_nets[sid].items():
            param_abs = max(param_abs, float(np.abs(sharded_nets[sid][name] - value).max()))
    row = {"folds": len(folds), "nets": len(folds), "devices": [str(d) for d in devices],
           "seconds_one_device": one_s, "seconds_sharded": sharded_s,
           "loss_rel": loss_rel, "param_abs": param_abs, "bars": SHARDED_SEARCH_BARS}
    if not (loss_rel <= SHARDED_SEARCH_BARS["loss_rel"]
            and param_abs <= SHARDED_SEARCH_BARS["param_abs"]):
        raise AssertionError(f"sharded search: over the bars {json.dumps(row)}")
    return row


def run_profiled_fit_motion(root) -> dict:
    """(d) the fit_motion CLI on the card over a 300 s ride with
    PILOTGURU_TPU_PROFILE_DIR set: a torch.profiler trace under
    <dir>/fit_motion/ holding the card's kernels, and the same files as
    the run without it."""
    from pilotguru_tpu_torch.cli import fit_motion
    from pilotguru_tpu_torch.utils.profiling import PROFILE_DIR_ENV

    arrays, _ = make_imu_ride(CORPUS["ride_s"], seed=0)
    ride_dir = os.path.join(root, "ride")
    write_ride_dir(ride_dir, arrays)
    profile_dir = os.path.join(root, "profile")
    outputs = {}
    for traced in (False, True):
        out = os.path.join(root, "traced" if traced else "plain")
        os.makedirs(out)
        argv = [f"--rotations_json={ride_dir}/rotations.json",
                f"--accelerations_json={ride_dir}/accelerations.json",
                f"--locations_json={ride_dir}/locations.json",
                f"--velocities_out_json={out}/velocities.json",
                f"--steering_out_json={out}/steering.json",
                f"--forward_axis_out_json={out}/forward.json"]
        saved = os.environ.pop(PROFILE_DIR_ENV, None)
        if traced:
            os.environ[PROFILE_DIR_ENV] = profile_dir
        try:
            with _platform("cuda"):
                start = time.perf_counter()
                if fit_motion.main(argv) != 0:
                    raise AssertionError("fit_motion: non-zero exit")
                seconds = time.perf_counter() - start
        finally:
            os.environ.pop(PROFILE_DIR_ENV, None)
            if saved is not None:
                os.environ[PROFILE_DIR_ENV] = saved
        outputs[traced] = ({n: open(os.path.join(out, n), "rb").read()
                            for n in sorted(os.listdir(out))}, seconds)
    trace = os.path.join(profile_dir, "fit_motion", "trace.json")
    if not os.path.isfile(trace):
        raise AssertionError(f"fit_motion with {PROFILE_DIR_ENV}: no trace at {trace}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    row = {"trace_bytes": os.path.getsize(trace), "events": len(events),
           "card_kernels": kernels, "seconds_plain": outputs[False][1],
           "seconds_traced": outputs[True][1],
           "outputs_equal": outputs[True][0] == outputs[False][0]}
    if kernels == 0 or not row["outputs_equal"]:
        raise AssertionError(f"fit_motion with {PROFILE_DIR_ENV}: {json.dumps(row)}")
    return row


def run_sharded_paths(ride, corpus):
    """Phase 15b over sharded_devices(): the card's name and power limit and
    the visible cards, then (a) to (d). Returns the sharded prefetch's
    launches."""
    import torch

    devices = sharded_devices()
    print(f"phase 15b (sharded paths) on {card_name_and_power()}; "
          f"{torch.cuda.device_count()} card(s) visible; devices "
          f"{[str(d) for d in devices]}", flush=True)
    root = tempfile.mkdtemp(prefix="pg_sharded_")
    try:
        rows = {"cards_visible": torch.cuda.device_count(),
                "devices": [str(d) for d in devices]}
        rows["corpus"] = run_sharded_corpus(corpus, devices)
        rows["prefetch"] = run_sharded_prefetch(ride, devices)
        rows["search"] = run_sharded_search(devices, os.path.join(root, "search"))
        rows["profiled_fit_motion"] = run_profiled_fit_motion(os.path.join(root, "profile"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 15b, the sharded paths against their one-device runs: {json.dumps(rows)}",
          flush=True)
    return rows["prefetch"]["launches"]


# The VO CLI in a child process where cv2 cannot be imported: the card
# needs no cv2 even on a machine that has it. It prints one JSON line: the
# exit code, the seconds, and the kernels' launches.
VO_CLI_CHILD = """
import json, sys, time
sys.modules["cv2"] = None  # import cv2 now raises ImportError
import torch
from pilotguru_tpu_torch.cli import optical_trajectories
from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel
counters = (fast_kernel.COUNTER, patch_kernel.COUNTER, patch_kernel.BLUR_COUNTER)
for c in counters:
    c.reset()
start = time.perf_counter()
code = optical_trajectories.main(sys.argv[1:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
print(json.dumps({"exit": code, "seconds": time.perf_counter() - start,
                  "cv2_unimportable": sys.modules["cv2"] is None,
                  "launches": {c.name: c.launches for c in counters},
                  "plain_cuda_calls": {c.name: c.plain_cuda_calls for c in counters}}))
"""


def run_vo_cli_image_list(frames_u8, out_dir, phase7c_trajectory, phase7c_frames_per_s):
    """The optical_trajectories CLI (its main, with its flags, at its
    defaults: chunked, with prefetch) on the parallax ride's frames written
    as a gray PNG image list with rgb.txt (phase 7's timestamps) and a
    settings YAML written by vo/camera.py, in a child process without cv2:
    the trajectory must equal phase 7c's parallax file (the same
    configuration in memory) byte for byte, K1 and K2 launch once a frame
    and K3 never. Returns the row (with the launches)."""
    from pilotguru_tpu_torch.video.io import write_image_list
    from pilotguru_tpu_torch.vo.camera import write_camera_settings

    start = time.perf_counter()
    index = write_image_list(os.path.join(out_dir, "frames"), frames_u8,
                             [int(round(i * 1e6 / 30.0)) for i in range(len(frames_u8))])
    settings = os.path.join(out_dir, "camera.yaml")
    write_camera_settings(ride_settings(), settings)
    written = time.perf_counter() - start
    traj_dir = os.path.join(out_dir, "trajectories")
    env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cuda", PYTHONPATH=REPO_DIR)
    run = subprocess.run(
        [sys.executable, "-c", VO_CLI_CHILD, f"--camera_settings={settings}",
         f"--in_video={index}", f"--out_dir={traj_dir}"],
        capture_output=True, text=True, env=env, timeout=900)
    if run.returncode != 0:
        raise AssertionError(f"VO CLI on the image list failed:\n{run.stderr[-4000:]}")
    child = json.loads(run.stdout.strip().splitlines()[-1])
    with open(os.path.join(traj_dir, "trajectory-0000.json"), "rb") as f:
        got = f.read()
    with open(phase7c_trajectory, "rb") as f:
        same = f.read() == got
    n = len(frames_u8)
    row = {"frames": n, "png_list_written_s": written, "cli_seconds": child["seconds"],
           "cli_frames_per_s": n / child["seconds"],
           "phase7c_frames_per_s": phase7c_frames_per_s, "launches": child["launches"],
           "plain_cuda_calls": child["plain_cuda_calls"],
           "cv2_unimportable": child["cv2_unimportable"],
           "segments": sorted(os.listdir(traj_dir)), "trajectory_equals_phase7c": same}
    print(f"VO CLI on a gray PNG image list (child process, cv2 unimportable): "
          f"{json.dumps(row)}", flush=True)
    want = {"fast_nms": n, "gather_patches": n, "gather_blurred_patches": 0}
    if not (child["exit"] == 0 and child["cv2_unimportable"] and same
            and row["segments"] == ["trajectory-0000.json"] and child["launches"] == want
            and not any(child["plain_cuda_calls"].values())):
        raise AssertionError(f"VO CLI on the image list: {json.dumps(row)}; want launches "
                             f"{want} and phase 7c's trajectory")
    return row


REPO_DIR = os.path.dirname(os.path.abspath(__file__))
GOLDEN_VIDEO = os.path.join(REPO_DIR, "tests", "golden", "inputs", "video.mp4")
GOLDEN_CAMERA = os.path.join(REPO_DIR, "tests", "golden", "inputs", "camera.yaml")
GOLDEN_TRAJECTORY = os.path.join(REPO_DIR, "tests", "golden", "expected", "vo",
                                 "trajectory-0000.json")
# tests/test_torch_slice.py's bars on the golden video: the centre RMSE after
# a Sim(3) alignment as a share of the path (3%), the plane normal (2
# degrees) and the per-frame rotation's mean (0.5 degrees) and worst. For
# the worst, the file's 1.25 degrees guards the CPU run's own RANSAC draws
# only; the bar it names for a run with other draws is the JAX package's
# per-frame run plus 0.1 degrees (1.402 + 0.1, test_torch_slice_replay.py).
# The card's float32 per-frame run read 1.365 (PERF.md); the CLI now runs
# chunked, as the JAX CLI that wrote the golden.
GOLDEN_PER_FRAME_ROTATION_MAX = 1.365
SLICE_BARS = {"centre_rmse_of_path": 0.03, "normal_deg": 2.0, "rotation_max_deg": 1.402 + 0.1,
              "rotation_mean_deg": 0.5}


def mp4_decoder(path: str):
    """The route that decodes ``path`` here (video/io.py), or None."""
    from pilotguru_tpu_torch.video import io as video_io

    try:
        next(video_io.read_frames_rgb(path))
    except RuntimeError:
        return None
    return "native libav reader" if video_io.native_video.available() else "cv2"


def trajectory_distance(a, b) -> dict:
    """Trajectory ``a`` against ``b`` (the same frames), as
    tests/test_torch_slice.py measures the port against the golden. Frame
    times may differ by 1 us: the cv2 route truncates the decoder's
    millisecond position (as the JAX package's does), the native reader
    rounds the stream's timestamps."""
    time_gap = int(np.abs(np.asarray(a.time_usec) - np.asarray(b.time_usec)).max())
    if not (np.array_equal(a.frame_id, b.frame_id) and time_gap <= 1):
        raise AssertionError("the trajectories cover different frames")
    _, _, rmse, length = sim3_aligned(a.translations, np.asarray(b.translations, np.float64))
    na, nb = np.cross(*a.plane), np.cross(*b.plane)
    cos = abs(na @ nb) / np.linalg.norm(na) / np.linalg.norm(nb)
    rot = [np.degrees(np.arccos(np.clip((np.trace(_quat_to_matrix(qa).T @ _quat_to_matrix(qb))
                                         - 1) / 2, -1, 1)))
           for qa, qb in zip(a.rotations, b.rotations)]
    return {"centre_rmse_of_path": float(rmse / length),
            "normal_deg": float(np.degrees(np.arccos(min(cos, 1.0)))),
            "rotation_max_deg": float(max(rot)), "rotation_mean_deg": float(np.mean(rot)),
            "time_gap_usec": time_gap}


FEATURE_FIELDS = ("kp_norm", "desc", "valid", "kp_level", "kp_angle")


def record_features(tracker, store: dict):
    """From now on every frame's features that ``tracker`` is fed go into
    ``store``: frame id -> (time_usec, the five arrays process_features
    takes, on the host). A frame fed twice (a chunk's unconsumed tail) is
    kept once; its features are the same."""
    from pilotguru_tpu_torch.vo import tracking

    process, chunk = tracker.process_features, tracker.process_chunk

    def keep(frame_id, time_usec, feats):
        store[int(frame_id)] = (int(time_usec),) + tuple(
            np.array(tracking.host_array(a)) for a in feats)

    def recording_process(kp_norm, desc, valid, frame_id, time_usec, kp_level, kp_angle):
        keep(frame_id, time_usec, (kp_norm, desc, valid, kp_level, kp_angle))
        return process(kp_norm, desc, valid, frame_id, time_usec, kp_level, kp_angle)

    def recording_chunk(frames):
        for f in frames[:tracker.config.track_chunk_frames]:
            keep(f.frame_id, f.time_usec, f.features)
        return chunk(frames)

    tracker.process_features = recording_process
    tracker.process_chunk = recording_chunk


def save_features(path, store: dict):
    """``store`` (record_features') as one npz file."""
    arrays = {}
    for frame_id, (time_usec, *feats) in store.items():
        arrays[f"{frame_id}.time_usec"] = np.asarray(time_usec, np.int64)
        arrays.update({f"{frame_id}.{k}": a for k, a in zip(FEATURE_FIELDS, feats)})
    np.savez(path, **arrays)


def load_features(path) -> dict:
    """save_features' file as record_features' dict."""
    with np.load(path) as data:
        ids = sorted({int(k.split(".")[0]) for k in data.files})
        return {i: (int(data[f"{i}.time_usec"]),) + tuple(data[f"{i}.{k}"]
                                                          for k in FEATURE_FIELDS)
                for i in ids}


def replayed_frames(store: dict):
    """The frames of ``store`` (record_features') in order, each carrying its
    features and no image: the segment loop feeds them to its trackers
    without extracting (feature_batch_size=0)."""
    from pilotguru_tpu_torch.vo import pipeline

    return [pipeline.VideoFrame(None, i, store[i][0], features=tuple(store[i][1:]))
            for i in sorted(store)]


def golden_cli_argv(out_dir):
    return [f"--camera_settings={GOLDEN_CAMERA}", f"--in_video={GOLDEN_VIDEO}",
            f"--out_dir={out_dir}"]


@contextlib.contextmanager
def frame_by_frame():
    """Within: the VO CLI's trackers track frame by frame
    (``track_chunk_frames=0``; the features still come through its
    prefetcher)."""
    from pilotguru_tpu_torch.vo import pipeline

    make = pipeline.tracker_from_settings
    pipeline.tracker_from_settings = (
        lambda *args, **kwargs: make(*args, **{**kwargs, "track_chunk_frames": 0}))
    try:
        yield
    finally:
        pipeline.tracker_from_settings = make


@contextlib.contextmanager
def features_recorded(store: dict):
    """Within: every tracker the segment loop makes records the features it
    is fed into ``store`` (record_features)."""
    from pilotguru_tpu_torch.vo import pipeline

    make = pipeline.tracker_from_settings

    def recording(*args, **kwargs):
        tracker = make(*args, **kwargs)
        record_features(tracker, store)
        return tracker

    pipeline.tracker_from_settings = recording
    try:
        yield
    finally:
        pipeline.tracker_from_settings = make


def run_golden_cli(out_dir, per_frame=False, features_to=None):
    """The VO CLI on the golden mp4 on the card (in this process, through
    the decoder found), at its defaults (chunked) or, with ``per_frame``,
    frame by frame: timed, K1 and K2 once a frame, one segment of the
    golden's 120 frames within SLICE_BARS of the golden trajectory.
    ``features_to``: a path where the features its trackers were fed are
    saved (save_features). Returns (row, trajectory path)."""
    from pilotguru_tpu_torch.cli import optical_trajectories
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory

    store: dict = {}
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    start = time.perf_counter()
    with _platform("cuda"), frame_by_frame() if per_frame else contextlib.nullcontext(), \
            features_recorded(store) if features_to else contextlib.nullcontext():
        if optical_trajectories.main(golden_cli_argv(out_dir)) != 0:
            raise AssertionError("VO CLI on the golden video: non-zero exit")
    seconds = time.perf_counter() - start
    if features_to:
        save_features(features_to, store)
    launches = {c.name: c.launches for c in counters}
    path = os.path.join(out_dir, "trajectory-0000.json")
    traj = read_trajectory(path)
    errors = trajectory_distance(traj, read_trajectory(GOLDEN_TRAJECTORY))
    row = {"frames": len(traj), "cli_seconds": seconds, "frames_per_s": len(traj) / seconds,
           "launches": launches, "against_golden": errors, "bars": SLICE_BARS,
           "segments": sorted(os.listdir(out_dir))}
    how = "frame by frame" if per_frame else "its defaults: chunked, with prefetch"
    print(f"VO CLI on the golden mp4 on the card ({how}): {json.dumps(row)}; worst rotation "
          f"against the golden {errors['rotation_max_deg']:.3f} degrees (the per-frame CLI "
          f"read {GOLDEN_PER_FRAME_ROTATION_MAX} on an H100)", flush=True)
    over = {k: errors[k] for k, v in SLICE_BARS.items() if not errors[k] <= v}
    want = {"fast_nms": 120, "gather_patches": 120, "gather_blurred_patches": 0}
    if over or launches != want or row["segments"] != ["trajectory-0000.json"]:
        raise AssertionError(f"VO CLI on the golden mp4: over the bars {over}, launches "
                             f"{launches} (want {want}), segments {row['segments']}")
    return row, path


# The dataset ride: a numpy-drawn road at 640x360, 30 fps, 600 frames, whose
# curve follows the IMU yaw rate; PilotNet's published 66x200x3 input after
# a crop of the sky and the hood.
ROAD = {"frames": 600, "width": 640, "height": 360, "fps": 30.0, "t0_usec": 1_000_000,
        "crop": {"crop_top": 150, "crop_bottom": 30}}


def road_yaw_rate(t_sec):
    return 0.3 * np.sin(2 * np.pi * t_sec / 7.0)


def road_speed(t_sec):
    return 9.0 + 3.0 * np.sin(2 * np.pi * t_sec / 37.0)


def render_road(seed: int = 21):
    """Yield ROAD["frames"] uint8 [H, W, 3] RGB frames: sky, grass with a
    fixed texture, and a road whose centre line bends with the yaw rate and
    whose lane dashes move with the speed."""
    h, w = ROAD["height"], ROAD["width"]
    rng = np.random.default_rng(seed)
    texture = rng.integers(-18, 19, (h, w, 1))
    horizon = int(0.4 * h)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    ground = rows > horizon
    background = np.clip(np.where(ground[..., None], np.array([60, 125, 50]),
                                  np.array([135, 180, 235])) + texture, 0, 255).astype(np.uint8)
    asphalt = np.clip(75 + texture // 2, 0, 255).astype(np.uint8).repeat(3, axis=2)
    depth = np.clip((rows - horizon) / (h - horizon), 1e-3, 1.0)  # 0 far, 1 near
    bend, half, dash_half = 260 * (1 - depth) ** 2, 20 + 260 * depth, 2 + 5 * depth
    travelled = 0.0
    for i in range(ROAD["frames"]):
        t = i / ROAD["fps"]
        travelled += road_speed(t) / ROAD["fps"]
        offset = np.abs(cols - (w / 2 + bend * road_yaw_rate(t)))
        road = (offset < half) & ground
        dash = (offset < dash_half) & (((3.0 / depth + travelled) % 4.0) < 2.0) & ground
        img = background.copy()
        img[road] = asphalt[road]
        img[dash] = 235
        yield img


def write_road_ride(root):
    """The road's frames as an RGB PNG image list, and tests/synthetic.py-
    shaped JSONs: frames.json, steering (IMU angular velocity, 200 Hz),
    velocities (200 Hz), the forward axis and the crop. Returns the paths."""
    from pilotguru_tpu_torch.formats import json_io, keys
    from pilotguru_tpu_torch.video.io import write_image_list

    n, t0 = ROAD["frames"], ROAD["t0_usec"]
    times = [t0 + int(round(i * 1e6 / ROAD["fps"])) for i in range(n)]
    paths = {"images": write_image_list(os.path.join(root, "frames"), render_road(), times)}
    paths["frames"] = os.path.join(root, "frames.json")
    json_io.write_json({keys.FRAMES: [{keys.FRAME_ID: i, keys.TIME_USEC: t}
                                      for i, t in enumerate(times)]}, paths["frames"])
    imu = np.arange(t0 - 100_000, times[-1] + 100_000, 5_000, dtype=np.int64)
    t_sec = (imu - t0) * 1e-6
    paths["steering"] = os.path.join(root, "steering.json")
    json_io.write_timestamped_values(imu, road_yaw_rate(t_sec), paths["steering"],
                                     keys.STEERING, "angular_velocity")
    paths["velocities"] = os.path.join(root, "velocities.json")
    json_io.write_timestamped_values(imu, road_speed(t_sec), paths["velocities"],
                                     keys.VELOCITIES, keys.SPEED_M_S)
    paths["forward"] = os.path.join(root, "forward.json")
    json_io.write_forward_axis(np.array([0.9998, 0.02, 0.0]), paths["forward"])
    paths["crop"] = os.path.join(root, "crop.json")
    json_io.write_json({"crop_settings": ROAD["crop"]}, paths["crop"])
    return paths


def dataset_argv(paths, out_dir):
    """make_steering_dataset's flags: every frame, labels now and 10 frames
    ahead, YUV at 66x200, float64 annotation on either device (so the card
    and the CPU write the same labels)."""
    return [f"--in_video={paths['images']}", f"--in_frames_json={paths['frames']}",
            f"--in_steering_json={paths['steering']}", "--steering_source=imu",
            f"--in_velocities_json={paths['velocities']}",
            f"--in_forward_axis_json={paths['forward']}",
            f"--crop_settings_json={paths['crop']}", f"--out_dir={out_dir}",
            "--frames_step=1", "--label_lookahead_frames=0,10", "--target_height=66",
            "--target_width=200", "--convert_to_yuv=1", "--save_png_every=100",
            "--dtype=float64"]


# The ensemble: 3 NVIDIA PilotNets at the published 66x200x3 input, head
# 10, batch norm on, the forward-axis LinearBias; weights from a numpy seed.
PILOTNET = {"nets": 3, "settings": {"net_name": "nvidia", "net_head_dims": 10,
                                    "label_dimensions": 1, "target_height": 66,
                                    "target_width": 200}}
# Card float32 against the CPU's float32, every frame's steering (TF32 off).
PREDICT_F32_BAR = 1e-4
# Card bfloat16 against the CPU's float32, every frame: 3.4 times the card's
# first reading, 8.93e-4 (RMS 3.2e-4, of outputs whose RMS is 0.067).
PREDICT_BF16_BAR = 3e-3


def write_pilotnet_checkpoints(root, seed: int = 5):
    """PILOTNET["nets"] flax msgpack checkpoints written by the port's codec:
    kernels ~ N(0, 1/fan_in), batch-norm scale, bias and statistics drawn
    from numpy ``seed``. Returns the paths."""
    from pilotguru_tpu_torch.cli.predict_video import network_from_settings
    from pilotguru_tpu_torch.ml import convert
    from pilotguru_tpu_torch.utils import msgpack

    rng = np.random.default_rng(seed)

    def draw(name, shape, path):
        if name == "kernel":
            std = 0.1 if "LinearBias" in path else 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.normal(0, std, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape)
        return rng.normal(0, 0.05, shape)  # bias, mean

    def fill(node, path=""):
        return {k: fill(v, f"{path}/{k}") if isinstance(v, dict)
                else draw(k, v.shape, path).astype(np.float32) for k, v in node.items()}

    template = convert.flax_variables(network_from_settings(PILOTNET["settings"], (66, 200, 3)))
    paths = []
    for i in range(PILOTNET["nets"]):
        paths.append(os.path.join(root, f"pilotnet-{i}.msgpack"))
        with open(paths[-1], "wb") as f:
            f.write(msgpack.packb(fill(template)))
    return paths


def predict_argv(paths, checkpoints, settings_json, out_json):
    return [f"--in_video={paths['images']}", f"--forward_axis_json={paths['forward']}",
            f"--net_settings_json={settings_json}", f"--in_model_weights={','.join(checkpoints)}",
            f"--out_steering_json={out_json}", "--convert_to_yuv=1",
            f"--crop_top={ROAD['crop']['crop_top']}",
            f"--crop_bottom={ROAD['crop']['crop_bottom']}",
            "--trajectory_frame_update_rate=1.0"]


# The CPU references of the new phases, in one child process beside the
# card's runs: each job is (CLI module, argv); prints one JSON line of
# seconds by job.
CPU_COMPANION = """
import importlib, json, sys, time
jobs = json.loads(sys.argv[1])
seconds = {}
import contextlib
import chip_smoke
for name, module, argv, per_frame in jobs:
    start = time.perf_counter()
    with chip_smoke.frame_by_frame() if per_frame else contextlib.nullcontext():
        if importlib.import_module("pilotguru_tpu_torch.cli." + module).main(argv) != 0:
            raise SystemExit(name + ": non-zero exit")
    seconds[name] = time.perf_counter() - start
print(json.dumps(seconds))
"""


def start_cpu_companion(jobs):
    # Four threads: the card's runs beside it keep the rest of the host.
    env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="4", PYTHONPATH=REPO_DIR)
    return subprocess.Popen([sys.executable, "-c", CPU_COMPANION, json.dumps(jobs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish_cpu_companion(proc):
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the CPU reference runs failed:\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def compare_datasets(card_dir, cpu_dir) -> dict:
    names = sorted(os.listdir(cpu_dir))
    if names != sorted(os.listdir(card_dir)):
        raise AssertionError("make_steering_dataset: the card and the CPU wrote other files")
    arrays = 0
    for name in names:
        a, b = os.path.join(card_dir, name), os.path.join(cpu_dir, name)
        if name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                if sorted(x.files) != sorted(y.files):
                    raise AssertionError(f"{name}: other arrays")
                for key in x.files:
                    if x[key].dtype != y[key].dtype or not np.array_equal(x[key], y[key]):
                        raise AssertionError(f"make_steering_dataset: {name} {key} differs "
                                             "between the card and the CPU")
                    arrays += 1
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"make_steering_dataset: {name} differs")
    return {"files": len(names), "examples": sum(n.endswith(".npz") for n in names),
            "pngs": sum(n.endswith(".png") for n in names), "arrays_equal": arrays}


def _steering(path):
    from pilotguru_tpu_torch.formats import json_io

    events = json_io.read_json(path)["steering"]
    return np.array([e["frame_id"] for e in events]), np.array([e["steering"] for e in events])


def forward_timings(checkpoints, reps=20) -> list:
    """The ensemble's forward pass alone on the card (inputs already there),
    float32 and bfloat16, at batch 1 and 1,024: CUDA-event ms (median of
    ``reps``), examples/s and peak device memory."""
    import torch

    from pilotguru_tpu_torch.cli.predict_video import load_predictor

    rows = []
    for dtype in ("float32", "bfloat16"):
        settings = {**PILOTNET["settings"], "compute_dtype": dtype}
        predictor = load_predictor(settings, checkpoints, (66, 200, 3), "cuda")
        for batch in (1, 1024):
            gen = torch.Generator(device="cuda").manual_seed(batch)
            inputs = {"frame_img": torch.rand((batch, 66, 200, 3), device="cuda", generator=gen),
                      "forward_axis": torch.rand((batch, 3), device="cuda", generator=gen)}

            def forward():
                with torch.no_grad():
                    return torch.stack([net(inputs) for net in predictor.nets]).mean(0)

            forward()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                forward()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            rows.append({"dtype": dtype, "batch": batch, "ms": ms,
                         "examples_per_s": 1e3 * batch / ms,
                         "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20})
            print(f"PilotNet x{PILOTNET['nets']} forward pass on the card: "
                  f"{json.dumps(rows[-1])}", flush=True)
    return rows


def device_idle_share(fn) -> dict:
    """Run ``fn`` under torch.profiler (CUDA activity): its wall seconds, the
    device's busy ms (kernels and copies, one stream) and the idle share;
    raises unless ``fn`` returns 0 (a CLI's exit code)."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        if fn() != 0:
            raise AssertionError("the profiled run exited non-zero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / wall}


# Training on the dataset ride (phase 13): PilotNet x3 at its published
# widths through the train CLI, SGD, batch 64, 3 epochs, dropout 0, no
# augmentation, --batch_use_prob=0.7 and the exp_recent_loss weighter, the
# dataset's two labels (now and 10 frames on). Every example trains and
# validates, as in the JAX package's user journey.
TRAIN = {"nets": 3, "batch": 64, "epochs": 3, "lr": 0.01, "batch_use_prob": 0.7,
         "weighter": {"name": "exp_recent_loss", "recent_loss_lr": 0.5,
                      "recent_loss_exp_scale": 2.0, "raw_weight_clip": 4.0}}
# Card float32 against the CPU's float32 (TF32 off) over the 3 epochs: each
# epoch's per-net train and val losses (relative) and the last checkpoints'
# parameters and batch statistics (absolute). This training amplifies
# rounding: two CPU runs that differ only in their thread count (their sums'
# order) read 0.211 and 3.20 apart (train_rounding.py --threads), and the
# card against the CPU 0.201 / 1.19 and 0.140 / 1.06 in two calls (PERF.md),
# so the bars hold the run to that spread, and TRAIN_STEP_BARS hold the
# first step to float32's own error.
TRAIN_F32_BARS = {"loss_rel": 0.5, "param_abs": 5.0}
# The first train step on the dataset's first batch, card against CPU
# (float32): per-net losses (relative) and every parameter but the biases
# just before batch norm, whose gradients are rounding noise (absolute).
# Read 4.0e-6 and 4.6e-4: float32's gradients of this step are themselves
# up to 6.6% of a layer's largest from float64 (train_rounding.py
# --gradients), and the step moves a parameter by lr times its gradient.
TRAIN_STEP_BARS = {"loss_rel": 1e-4, "param_abs": 2e-3}
# Card bfloat16 against the card's float32, each epoch's per-net losses
# (relative), besides finite and falling: read 0.29 (the spread above).
TRAIN_BF16_BAR = 0.5
# The train step's throughput: synthetic uint8 frames 66x220 (crop to 200),
# augmentation on.
THROUGHPUT = {"batches": (128, 512, 1024, 4096), "reps": 10, "width": 220,
              "epoch_examples": 8192, "epoch_batch": 1024}


def train_argv(data_dir, out_dir, dtype, epochs=None):
    return [f"--data_dirs={data_dir}", f"--validation_data_dirs={data_dir}",
            f"--batch_size={TRAIN['batch']}", f"--batch_use_prob={TRAIN['batch_use_prob']}",
            f"--epochs={epochs or TRAIN['epochs']}", "--optimizer=sgd",
            f"--learning_rate={TRAIN['lr']}", "--target_height=66", "--target_width=200",
            "--net_name=nvidia", f"--num_nets_to_train={TRAIN['nets']}", "--label_dimensions=2",
            "--dropout_prob=0", f"--sample_weighter_options={json.dumps(TRAIN['weighter'])}",
            f"--out_dir={out_dir}", f"--compute_dtype={dtype}"]


def _train_log(out_dir):
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def compare_training(a_dir, b_dir) -> dict:
    """Two train CLI runs on the same data: the largest relative difference
    of the per-epoch per-net losses, whether markers and lr_scale agree,
    and the largest absolute difference of the last checkpoints' leaves."""
    from pilotguru_tpu_torch.ml import training

    la, lb = _train_log(a_dir), _train_log(b_dir)
    if len(la) != len(lb):
        raise AssertionError("training: the runs logged other epochs")
    loss_rel, same = 0.0, True
    for ea, eb in zip(la, lb):
        for key in ("train_loss_per_net", "val_loss_per_net"):
            x, y = np.asarray(ea[key]), np.asarray(eb[key])
            loss_rel = max(loss_rel, float(np.max(np.abs(x - y) / np.abs(y))))
        same &= (ea["improvement_marker"] == eb["improvement_marker"]
                 and ea["lr_scale_per_net"] == eb["lr_scale_per_net"])
    param_abs = 0.0
    names = sorted(n for n in os.listdir(b_dir) if n.endswith(".msgpack"))
    if names != sorted(n for n in os.listdir(a_dir) if n.endswith(".msgpack")):
        raise AssertionError("training: the runs wrote other checkpoints")
    for name in names:
        if not name.endswith("-last.msgpack"):
            continue
        ta = _flat_tree(training.load_net(os.path.join(a_dir, name)))
        tb = _flat_tree(training.load_net(os.path.join(b_dir, name)))
        param_abs = max(param_abs, max(float(np.abs(ta[k] - tb[k]).max()) for k in tb))
    return {"loss_rel": loss_rel, "markers_and_lr_scale_equal": bool(same),
            "param_abs": param_abs, "checkpoints": names,
            "val_loss_by_epoch": [e["val_loss"] for e in lb],
            "train_loss_by_epoch": [e["train_loss"] for e in lb]}


def _pre_norm_bias(name) -> bool:
    return name.endswith("Conv_0/bias") or (name.startswith("FcBlock_")
                                            and name.endswith("Dense_0/bias"))


def check_train_step(data_dir) -> dict:
    """The train CLI's first step (its init, SGD at TRAIN's learning rate,
    the dataset's first TRAIN["batch"] examples, uniform weights) on the
    card and on the CPU in float32: within TRAIN_STEP_BARS."""
    import torch

    from pilotguru_tpu_torch.ml import augmentation as aug
    from pilotguru_tpu_torch.ml import convert, data, models, training

    names = ["frame_img", "forward_axis", "steering"]
    dataset = data.load_dataset([data_dir], names)
    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 2,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    tx = training.make_optimizer("sgd", TRAIN["lr"])
    settings = training.TrainSettings(epochs=1, batch_size=TRAIN["batch"],
                                      augment=aug.AugmentSettings(target_width=200))
    b, n = TRAIN["batch"], TRAIN["nets"]
    result = {}
    for device in ("cpu", "cuda"):
        state = training.init_ensemble(model, {}, n, tx, device=device)
        inputs = {k: torch.as_tensor(dataset[k][:b]).to(device) for k in names[:2]}
        state, losses, _ = training.make_train_step(model, tx, settings)(
            state, inputs, torch.as_tensor(dataset["steering"][:b]).to(device),
            torch.ones((n, b), device=device), torch.ones(n, dtype=torch.bool, device=device),
            torch.Generator(device=device).manual_seed(0))
        result[device] = (losses.cpu().numpy(),
                          _flat_tree(convert.ensemble_to_flax(state.params, {})[0]))
    (cpu_loss, cpu_params), (card_loss, card_params) = result["cpu"], result["cuda"]
    row = {"loss_rel": float(np.max(np.abs(card_loss - cpu_loss) / np.abs(cpu_loss))),
           "param_abs": max(float(np.abs(card_params[k] - v).max())
                            for k, v in cpu_params.items() if not _pre_norm_bias(k)),
           "pre_norm_bias_abs": max(float(np.abs(card_params[k] - v).max())
                                    for k, v in cpu_params.items() if _pre_norm_bias(k)),
           "bars": TRAIN_STEP_BARS}
    print(f"the train CLI's first step, card against CPU (float32): {json.dumps(row)}",
          flush=True)
    if not all(row[k] <= v for k, v in TRAIN_STEP_BARS.items()):
        raise AssertionError(f"train step on the card: over the bars: {row}")
    return row


def search_settings(root) -> str:
    """Three hyperparams_search folds of PilotNet, two sharing a program and
    differing in learning rate, the third with another batch size: two
    groups. Returns the settings files' glob."""
    from pilotguru_tpu_torch.formats import json_io

    base = {"input_names": ["frame_img", "forward_axis"], "label_names": ["steering"],
            "net_name": "nvidia", "target_height": 66, "target_width": 200,
            "label_dimensions": 2, "optimizer": "sgd", "batch_size": TRAIN["batch"],
            "linear_bias_options": [{"input_name": "forward_axis", "input_dims": 3}],
            "compute_dtype": "float32"}
    folds = {"lr-0.01": {"learning_rate": 0.01}, "lr-0.005": {"learning_rate": 0.005},
             "batch-128": {"learning_rate": 0.01, "batch_size": 128}}
    os.makedirs(root, exist_ok=True)
    for sid, extra in folds.items():
        json_io.write_json({**base, **extra, "settings_id": sid},
                           os.path.join(root, f"{sid}.json"))
    return os.path.join(root, "*.json")


def run_search(data_dir, root) -> dict:
    """hyperparams_search for one epoch on the card: each fold's log (one
    epoch, finite losses) and last checkpoint in its own directories."""
    from pilotguru_tpu_torch.cli import hyperparams_search

    pattern = search_settings(os.path.join(root, "settings"))
    argv = [f"--data_dirs={data_dir}", f"--validation_data_dirs={data_dir}",
            f"--train_settings_json_glob={pattern}", "--epochs=1",
            f"--out_dir={root}/out", f"--log_dir={root}/log", "--num_nets_to_train=1",
            f"--batch_use_prob={TRAIN['batch_use_prob']}"]
    start = time.perf_counter()
    if hyperparams_search.main(argv) != 0:
        raise AssertionError("hyperparams_search: non-zero exit")
    row = {"seconds": time.perf_counter() - start, "folds": {}}
    for sid in sorted(os.listdir(os.path.join(root, "log"))):
        log = _train_log(os.path.join(root, "log", sid))
        files = sorted(os.listdir(os.path.join(root, "out", sid)))
        row["folds"][sid] = {"epochs": len(log), "val_loss": log[-1]["val_loss"],
                             "checkpoints": files}
        if (len(log) != 1 or not np.isfinite(log[-1]["val_loss"])
                or "model-0-last.msgpack" not in files):
            raise AssertionError(f"hyperparams_search: fold {sid}: {row['folds'][sid]}")
    if len(row["folds"]) != 3:
        raise AssertionError(f"hyperparams_search: folds {sorted(row['folds'])}")
    return row


def _device_ops(fn) -> int:
    """The device operations (kernels, copies, sets) that ``fn`` issues."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def train_throughput() -> list:
    """The folded PilotNet x3 train step with augmentation on (shift 10 px,
    blur prob 0.5, grayscale 0.2, PCA directions), SGD, on synthetic uint8
    66x220 frames from a numpy seed, in float32 and bfloat16: per batch size,
    CUDA-event ms a step (median), examples/s (each example trains the 3
    nets), peak device memory and device operations a step; and the
    device's idle share over one train_models epoch."""
    import torch

    from pilotguru_tpu_torch.ml import augmentation as aug
    from pilotguru_tpu_torch.ml import models, training, weighting

    rng = np.random.default_rng(3)
    width = THROUGHPUT["width"]
    biggest = max(THROUGHPUT["batches"])
    frames = rng.integers(0, 256, (biggest, 66, width, 3), dtype=np.uint8)
    axis = rng.normal(0, 1, (biggest, 3)).astype(np.float32)
    labels = rng.normal(0, 0.3, (biggest, 2)).astype(np.float32)
    augment = aug.AugmentSettings(
        target_width=200, max_horizontal_shift_pixels=10, horizontal_label_shift_rate=(0.1, 0.1),
        blur_prob=0.5, grayscale_interpolate_prob=0.2,
        random_shift_directions=aug.pca_rgb_directions(frames[:64] / 255.0))
    bias = [{"input_name": "forward_axis", "input_dims": 3}]
    rows = []
    for dtype in ("float32", "bfloat16"):
        options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 2,
                   "dropout_prob": 0.0, "compute_dtype": dtype}
        model = models.make_network(options, bias, (66, 200, 3))
        tx = training.make_optimizer("sgd", 1e-3)
        generator = torch.Generator(device="cuda").manual_seed(0)
        for batch in THROUGHPUT["batches"]:
            settings = training.TrainSettings(epochs=1, batch_size=batch, augment=augment)
            step = training.make_train_step(model, tx, settings)
            state = training.init_ensemble(model, {}, TRAIN["nets"], tx, device="cuda")
            inputs = {"frame_img": torch.as_tensor(frames[:batch]).cuda(),
                      "forward_axis": torch.as_tensor(axis[:batch]).cuda()}
            y = torch.as_tensor(labels[:batch]).cuda()
            w = torch.ones((TRAIN["nets"], batch), device="cuda")
            mask = torch.ones(TRAIN["nets"], dtype=torch.bool, device="cuda")
            for _ in range(2):
                state, losses, _ = step(state, inputs, y, w, mask, generator)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(THROUGHPUT["reps"]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, losses, _ = step(state, inputs, y, w, mask, generator)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            peak = torch.cuda.max_memory_allocated() / 2**20
            ops = _device_ops(lambda: step(state, inputs, y, w, mask, generator))
            if not torch.isfinite(losses).all():
                raise AssertionError(f"train step {dtype} batch {batch}: losses {losses}")
            rows.append({"dtype": dtype, "batch": batch, "ms": ms,
                         "examples_per_s": 1e3 * batch / ms, "peak_device_mib": peak,
                         "device_ops_per_step": ops})
            print(f"PilotNet x{TRAIN['nets']} train step on the card: {json.dumps(rows[-1])}",
                  flush=True)
            del state, inputs
        n = THROUGHPUT["epoch_examples"]
        data = {"frame_img": np.resize(frames, (n,) + frames.shape[1:]),
                "forward_axis": np.resize(axis, (n, 3)), "steering": np.resize(labels, (n, 2))}
        val = {k: v[:512] for k, v in data.items()}
        settings = training.TrainSettings(epochs=1, batch_size=THROUGHPUT["epoch_batch"],
                                          augment=augment)
        state = training.init_ensemble(model, {}, TRAIN["nets"], tx, device="cuda")
        weighters = [weighting.UniformWeighter() for _ in range(TRAIN["nets"])]
        with tempfile.TemporaryDirectory() as out_dir:
            def epoch():
                training.train_models(model, state, tx, data, val, ["frame_img", "forward_axis"],
                                      "steering", weighters, settings, out_dir, print_log=False)
                return 0
            idle = device_idle_share(epoch)
        idle.update(dtype=dtype, examples=n, batch=THROUGHPUT["epoch_batch"],
                    examples_per_s=n / idle["wall_s"])
        rows.append({"epoch": idle})
        print(f"one train_models epoch on the card ({n} examples, batch "
              f"{THROUGHPUT['epoch_batch']}, {dtype}): {json.dumps(idle)}", flush=True)
    return rows


def write_inference_inputs(root) -> dict:
    """The road ride (write_road_ride), the PilotNet checkpoints and their
    settings JSONs in float32 and bfloat16, under ``root``."""
    from pilotguru_tpu_torch.formats import json_io

    paths = write_road_ride(os.path.join(root, "road"))
    checkpoints = write_pilotnet_checkpoints(root)
    settings = {}
    for dtype in ("float32", "bfloat16"):
        settings[dtype] = os.path.join(root, f"settings-{dtype}.json")
        json_io.write_json({**PILOTNET["settings"], "compute_dtype": dtype}, settings[dtype])
    return {"root": root, "paths": paths, "checkpoints": checkpoints, "settings": settings}


def run_frame_input_phases(root):
    """make_steering_dataset on the road ride, predict_video with the
    PilotNet ensemble, the train CLI on the dataset in float32 and
    bfloat16, predict_video with the card's trained checkpoints and a brief
    hyperparams_search, on the card; their CPU references run beside in one
    child process. Returns the rows. (The golden mp4's card runs are in the
    lanes, the forward pass's and the train step's timings after them.)"""
    from pilotguru_tpu_torch.cli import make_steering_dataset, predict_video, train
    from pilotguru_tpu_torch.formats import json_io

    rows = {}
    start = time.perf_counter()
    rows["inputs"] = inputs = write_inference_inputs(root)
    paths, checkpoints, settings = inputs["paths"], inputs["checkpoints"], inputs["settings"]
    rows["inputs_written_s"] = time.perf_counter() - start
    out = {k: os.path.join(root, k) for k in ("data_card", "data_cpu", "train_cpu",
                                              "train_card_float32", "train_card_bfloat16",
                                              "train_card_float32_again",
                                              "search")}
    settings["trained"] = os.path.join(root, "settings-trained.json")
    json_io.write_json({**PILOTNET["settings"], "label_dimensions": 2,
                        "compute_dtype": "float32"}, settings["trained"])
    trained = [os.path.join(out["train_card_float32"], f"model-{i}-last.msgpack")
               for i in range(TRAIN["nets"])]
    # The CPU trains on its own dataset, which must equal the card's.
    jobs = [("dataset", "make_steering_dataset", dataset_argv(paths, out["data_cpu"]), False),
            ("predict float32", "predict_video",
             predict_argv(paths, checkpoints, settings["float32"],
                          os.path.join(root, "predict-cpu.json")), False),
            ("train float32", "train", train_argv(out["data_cpu"], out["train_cpu"], "float32"),
             False)]
    companion = start_cpu_companion(jobs)
    try:
        counters = _kernel_counters()
        times = {}
        with _platform("cuda"):
            for c in counters:
                c.reset()
            _run_cli(times, "dataset", make_steering_dataset.main,
                     dataset_argv(paths, out["data_card"]))
            # The float32 run under the profiler (its cost is within the
            # runs' spread): its wall time and the device's idle share.
            rows["idle"] = device_idle_share(lambda: predict_video.main(predict_argv(
                paths, checkpoints, settings["float32"],
                os.path.join(root, "predict-card-float32.json"))))
            times["predict float32"] = rows["idle"]["wall_s"]
            _run_cli(times, "predict bfloat16", predict_video.main,
                     predict_argv(paths, checkpoints, settings["bfloat16"],
                                  os.path.join(root, "predict-card-bfloat16.json")))
            for dtype in ("float32", "bfloat16"):
                _run_cli(times, f"train {dtype}", train.main,
                         train_argv(out["data_card"], out[f"train_card_{dtype}"], dtype))
            _run_cli(times, "train float32 again", train.main,
                     train_argv(out["data_card"], out["train_card_float32_again"], "float32"))
            _run_cli(times, "predict trained", predict_video.main,
                     predict_argv(paths, trained, settings["trained"],
                                  os.path.join(root, "predict-trained.json")))
            rows["search"] = run_search(out["data_card"], out["search"])
            _no_kernel_launches("dataset, inference and training", counters)
    finally:
        cpu_seconds = finish_cpu_companion(companion)

    n = ROAD["frames"]
    compared = compare_datasets(out["data_card"], out["data_cpu"])
    rows["dataset"] = {**compared, "card_seconds": times["dataset"],
                       "card_examples_per_s": compared["examples"] / times["dataset"],
                       "cpu_seconds": cpu_seconds["dataset"]}
    print(f"make_steering_dataset on the road ride ({n} frames 640x360 -> 66x200 YUV), card "
          f"against CPU: {json.dumps(rows['dataset'])}", flush=True)
    if compared["examples"] < 0.9 * n:
        raise AssertionError(f"make_steering_dataset wrote {compared['examples']} examples")

    ids, cpu32 = _steering(os.path.join(root, "predict-cpu.json"))
    diffs = {}
    for dtype in ("float32", "bfloat16"):
        card_ids, card = _steering(os.path.join(root, f"predict-card-{dtype}.json"))
        if not (np.array_equal(card_ids, ids) and len(ids) == n and np.isfinite(card).all()):
            raise AssertionError(f"predict_video {dtype}: frames or values malformed")
        d = card - cpu32
        diffs[dtype] = {"max_abs": float(np.abs(d).max()), "rms": float(np.sqrt(np.mean(d ** 2)))}
    rows["predict"] = {"frames": n, "output_rms": float(np.sqrt(np.mean(cpu32 ** 2))),
                       "output_std": float(np.std(cpu32)),
                       "card_against_cpu_float32": diffs,
                       "bars": {"float32": PREDICT_F32_BAR, "bfloat16": PREDICT_BF16_BAR},
                       "card_frames_per_s": {k: n / times[f"predict {k}"]
                                             for k in ("float32", "bfloat16")},
                       "cpu_float32_frames_per_s": n / cpu_seconds["predict float32"],
                       "float32_run_profiled": rows["idle"]}
    print(f"predict_video, PilotNet x{PILOTNET['nets']} at 66x200x3 on the road ride: "
          f"{json.dumps(rows['predict'])}", flush=True)
    if not (diffs["float32"]["max_abs"] <= PREDICT_F32_BAR
            and diffs["bfloat16"]["max_abs"] <= PREDICT_BF16_BAR
            and rows["predict"]["output_std"] > 1e-4):
        raise AssertionError(f"predict_video: over the bars {json.dumps(diffs)}")

    rows["train"] = check_training(out, times, cpu_seconds["train float32"])
    print(f"hyperparams_search on the card (3 folds, 2 groups, 1 epoch): "
          f"{json.dumps(rows['search'])}", flush=True)
    trained_ids, predicted = _steering(os.path.join(root, "predict-trained.json"))
    t_sec = np.arange(n) / ROAD["fps"]
    rows["predict_trained"] = {
        "frames": len(predicted), "seconds": times["predict trained"],
        "corr_with_yaw_rate": float(np.corrcoef(predicted, road_yaw_rate(t_sec))[0, 1]),
        "output_std": float(np.std(predicted))}
    print(f"predict_video with the card's trained checkpoints over the road ride: "
          f"{json.dumps(rows['predict_trained'])}", flush=True)
    # The correlation with the road's yaw rate is reported, not held: after
    # 3 epochs the nets' running batch statistics (momentum 0.9, about 21
    # steps) still lag, the eval-mode val loss stays near 0.30 while the
    # train loss falls to 0.057, and the correlation read 0.928 on the CPU
    # and 0.787 and 0.218 in two card calls (PERF.md).
    if not (np.array_equal(trained_ids, ids) and np.isfinite(predicted).all()
            and rows["predict_trained"]["output_std"] > 1e-4):
        raise AssertionError(f"predict_video with the trained checkpoints: "
                             f"{rows['predict_trained']}")
    return rows


def start_golden_cpu(out_dir):
    """The port's CPU run of the VO CLI on the golden mp4, frame by frame,
    in a child process (the CPU companion's), against which the card's
    frame-by-frame run is held. The chunked card run is held to the golden
    and to the CPU's replay of its own features (run_golden_lane): on
    features extracted apart, the card's chunked float32 run and the CPU's
    chunked float64 run parted by 1.873 degrees on an H100 (PERF.md)."""
    return start_cpu_companion([("golden VO", "optical_trajectories",
                                 golden_cli_argv(out_dir), True)])


def replay_golden_features(features_path, out_dir):
    """The segment loop over the golden mp4's saved features (no decoding,
    no extraction) on the CPU in float32, at the CLI's defaults otherwise
    (chunks of 16 through keyframes, each tracker's RANSAC generator at
    seed 0, as the card's CLI run). Prints one JSON line."""
    import torch

    from pilotguru_tpu_torch.vo import pipeline
    from pilotguru_tpu_torch.vo.camera import read_camera_settings

    start = time.perf_counter()
    segments, frames = pipeline.track_video_segments(
        replayed_frames(load_features(features_path)), read_camera_settings(GOLDEN_CAMERA),
        out_dir, device="cpu", dtype=torch.float32, feature_batch_size=0)
    print(json.dumps({"golden replay": time.perf_counter() - start, "segments": segments,
                      "frames": frames}))


def start_golden_replay(features_path, out_dir):
    """replay_golden_features in a child process with the CPU companion's
    environment, one thread."""
    env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", PYTHONPATH=REPO_DIR)
    code = "import sys, chip_smoke; chip_smoke.replay_golden_features(*sys.argv[1:])"
    return subprocess.Popen([sys.executable, "-c", code, features_path, out_dir],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def check_golden_replay(row, card_path, replay_dir, replay) -> dict:
    """The card's chunked float32 golden run against the CPU's float32
    replay of the card's features (the same features and RANSAC draws,
    chunked), within SLICE_BARS."""
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory

    cpu = read_trajectory(os.path.join(replay_dir, "trajectory-0000.json"))
    distance = trajectory_distance(read_trajectory(card_path), cpu)
    row.update(replay=replay, card_against_replay=distance)
    print(f"VO CLI on the golden mp4 at its defaults, card float32 against the port's CPU "
          f"float32 replay of the card's features (chunked, {replay['golden replay']:.1f} s, "
          f"{replay['segments']} segment(s)): {json.dumps(distance)}; bars "
          f"{json.dumps(SLICE_BARS)}", flush=True)
    over = {k: distance[k] for k, v in SLICE_BARS.items() if not distance[k] <= v}
    if over or replay["segments"] != 1:
        raise AssertionError(f"golden mp4: the card's chunked run is far from the CPU's replay "
                             f"of its features: {over}, {replay['segments']} segment(s)")
    return row


def check_golden_against_cpu(row, card_path, cpu_dir, cpu_seconds) -> dict:
    """The card's frame-by-frame golden run against the CPU's, within
    SLICE_BARS."""
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory

    cpu = read_trajectory(os.path.join(cpu_dir, "trajectory-0000.json"))
    distance = trajectory_distance(read_trajectory(card_path), cpu)
    row.update(cpu_seconds=cpu_seconds["golden VO"], card_against_cpu=distance)
    print(f"VO CLI on the golden mp4 frame by frame, card float32 against the port's CPU "
          f"run (float64, same frames): {json.dumps(distance)}; bars "
          f"{json.dumps(SLICE_BARS)}", flush=True)
    over = {k: distance[k] for k, v in SLICE_BARS.items() if not distance[k] <= v}
    if over:
        raise AssertionError(f"golden mp4: the card's run is far from the CPU's: {over}")
    return row


# ---------------------------------------------------------------------------
# Phases 12e to 12j: live inference, the saliency tool, the dense BA oracle,
# map checkpoints, the VO CLI's visualization and the host tools.

# 12h: phase 7's tracker is saved after this frame and resumed from the file.
MAP_SAVE_FRAME = 100
# 12f: the saliency on the card against the CPU, both float32 (TF32 off).
# A ReLU net's input gradient is constant wherever the same units are
# active, so the two devices' rounding (forward outputs 7.5e-8 apart)
# moves it only where a unit's pre-activation sits within rounding of zero
# and flips: there the map changes by that unit's whole contribution (the
# first card reading, 6.0e-3 of the map's largest value, PERF.md). The bars
# hold the RMS of the difference over the RMS of the map, and the share of
# pixels off by more than 1e-4 of the map's largest value; the largest
# difference is reported. Each bar sits near the geometric mean of the
# float32 reading (RMS 6.0e-4, 0.55% of pixels) and the upper reading with
# TF32 on (RMS 2.8e-2, 56% of pixels; PERF.md), so either side has room of
# about 7 to 10 times.
SALIENCY = {"frames": 64, "batch": 8, "rms_share": 4e-3, "pixels_off_share": 5e-2}
# 12g: tests/test_vo_core.py::test_schur_matches_dense_solver's atol.
DENSE_BA_BARS = {"poses_abs": 1e-5, "points_abs": 1e-4}
# 12j: calibrate on board.mp4 against tests/golden/expected/camera_calib.yaml,
# relative, on every number (cv2's threaded calibrateCamera moves the tenth
# digit from run to run; the golden came from cv2 5.0, this card's machine
# has 4.13).
CALIBRATE_BAR = 1e-6


@contextlib.contextmanager
def capture_parallax_state(map_path):
    """While phase 7 runs: the arguments of the last bundle_adjust call (the
    local BA of the ride's last keyframe) and a map checkpoint
    (vo/map_io.py) written after frame MAP_SAVE_FRAME; a save leaves the run
    as it is. The save's host time, from a synchronized start (the wait for
    the device's queued work is "sync_ms"), goes to "seconds", which
    run_path takes off phase 7's times. Yields the dict that receives
    them."""
    import torch

    from pilotguru_tpu_torch.vo import map_io, tracking

    captured = {"seconds": 0.0}
    adjust = tracking.bundle_adjust
    process = tracking.MonocularTracker.process_features

    def recording_adjust(problem, **kwargs):
        captured["ba"] = (problem, kwargs)
        return adjust(problem, **kwargs)

    def saving_process(self, kp_norm, desc, valid, frame_id, *args, **kwargs):
        state = process(self, kp_norm, desc, valid, frame_id, *args, **kwargs)
        if frame_id == MAP_SAVE_FRAME:
            start = time.perf_counter()
            torch.cuda.synchronize()
            synced = time.perf_counter()
            map_io.save_tracker_map(self, map_path)
            end = time.perf_counter()
            captured["seconds"] += end - start
            captured["map"] = {"path": map_path, "state": state,
                               "sync_ms": 1e3 * (synced - start),
                               "save_ms": 1e3 * (end - synced),
                               "bytes": os.path.getsize(map_path)}
        return state

    tracking.bundle_adjust = recording_adjust
    tracking.MonocularTracker.process_features = saving_process
    try:
        yield captured
    finally:
        tracking.bundle_adjust = adjust
        tracking.MonocularTracker.process_features = process


def _subscriber(address, received, done):
    """A ZMQ SUB thread on ``address`` that stores every message until
    ``done`` is set and a receive then times out."""
    import threading

    import zmq

    ready = threading.Event()

    def run():
        context = zmq.Context()
        sub = context.socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.RCVTIMEO, 200)
        sub.connect(address)
        ready.set()
        try:
            while True:
                try:
                    received.append(sub.recv_json())
                except zmq.Again:
                    if done.is_set():
                        return
        finally:
            sub.close(linger=0)
            context.term()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    ready.wait(10)
    return thread


def video_frames_and_shape(path):
    """(frames, the first frame's shape) of a video, decoded by video/io.py."""
    from pilotguru_tpu_torch.video.io import read_video_rgb

    count, shape = 0, None
    for _, frame in read_video_rgb(path):
        count += 1
        shape = shape or frame.shape
    return count, shape


def in_order_subsequence(values, reference, atol) -> bool:
    """Whether ``values`` equal, in order, some entries of ``reference``
    within ``atol``."""
    j = 0
    for v in values:
        while j < len(reference) and abs(reference[j] - v) > atol:
            j += 1
        if j == len(reference):
            return False
        j += 1
    return True


def run_predict_live(inputs, reference_json) -> dict:
    """12e: predict_live on the card over the road ride's PNG list with the
    PilotNet x3 checkpoints (float32), a ZMQ SUB thread on ipc://: every
    received value an in-order subsequence of phase 12's float32
    predict_video steering x 90 within PREDICT_F32_BAR (in steering units)."""
    import threading

    from pilotguru_tpu_torch.cli import predict_live

    paths, checkpoints = inputs["paths"], inputs["checkpoints"]
    _, reference = _steering(reference_json)
    address = f"ipc://{os.path.join(inputs['root'], 'steering-predict')}"
    received, done = [], threading.Event()
    thread = _subscriber(address, received, done)
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    stats = {}
    try:
        with _platform("cuda"):
            rc = predict_live.main([
                f"--in_video_file={paths['images']}", f"--forward_axis_json={paths['forward']}",
                f"--net_settings_json={inputs['settings']['float32']}",
                f"--in_model_weights={','.join(checkpoints)}",
                f"--steering_prediction_socket={address}", "--convert_to_yuv=1",
                f"--crop_top={ROAD['crop']['crop_top']}",
                f"--crop_bottom={ROAD['crop']['crop_bottom']}",
                f"--max_frames={ROAD['frames']}"], stats=stats)
    finally:
        done.set()
        thread.join(timeout=30)
    _no_kernel_launches("predict_live", counters)
    values = np.array([m["s"] for m in received]) / 90.0
    host_ms = 1e3 * np.asarray(stats["host_seconds"])
    row = {"frames": stats["frames"], "seconds": stats["seconds"],
           "frames_per_s": stats["frames"] / stats["seconds"],
           "messages_received": len(values),
           "host_ms_read_to_send": {"mean": float(host_ms.mean()),
                                    "median": float(np.median(host_ms)),
                                    "p90": float(np.percentile(host_ms, 90)),
                                    "first": float(host_ms[0])},
           "bar": PREDICT_F32_BAR}
    print(f"predict_live on the card (PilotNet x{PILOTNET['nets']}, float32, the road ride): "
          f"{json.dumps(row)}", flush=True)
    if not (rc == 0 and stats["frames"] == ROAD["frames"] and len(values)
            and np.isfinite(values).all()
            and in_order_subsequence(values, reference, PREDICT_F32_BAR)):
        raise AssertionError(f"predict_live: the received values are not an in-order "
                             f"subsequence of predict_video's ({len(values)} received)")
    return row


def road_model_inputs(paths, count):
    """The first ``count`` road frames as predict_video prepares them:
    (crops [N, h, w, 3] uint8, model inputs [N, 66, 200, 3] float32)."""
    from pilotguru_tpu_torch.ml.prediction import frame_to_model_input
    from pilotguru_tpu_torch.video.io import read_frames_rgb

    crops, images = [], []
    for _, _, rgb in read_frames_rgb(paths["images"]):
        model_input, _ = frame_to_model_input(
            rgb, crop_top=ROAD["crop"]["crop_top"], crop_bottom=ROAD["crop"]["crop_bottom"],
            target_height=66, target_width=200, convert_to_yuv=True)
        crops.append(rgb[ROAD["crop"]["crop_top"]:ROAD["height"] - ROAD["crop"]["crop_bottom"]])
        images.append(model_input[0])
        if len(images) == count:
            break
    return np.stack(crops), np.stack(images)


def run_saliency(inputs) -> dict:
    """12f: the saliency gradient (render_input_pixel_importance.saliency)
    on the card against the port's CPU on SALIENCY["frames"] road frames at
    batch SALIENCY["batch"], float32, with the same comparison under TF32
    and bfloat16 compute printed as the upper readings; then the CLI over
    the whole ride on the card: seconds, frames/s, peak device memory,
    frames written."""
    import torch

    from pilotguru_tpu_torch.cli import render_input_pixel_importance as pixel_importance
    from pilotguru_tpu_torch.cli.predict_video import load_predictor
    from pilotguru_tpu_torch.formats import json_io

    paths, checkpoints = inputs["paths"], inputs["checkpoints"]
    _, images = road_model_inputs(paths, SALIENCY["frames"])
    axis = torch.from_numpy(json_io.read_forward_axis(paths["forward"]).astype(np.float32))

    def nets_of(compute_dtype, device):
        settings = {**PILOTNET["settings"], "compute_dtype": compute_dtype}
        return load_predictor(settings, checkpoints, (66, 200, 3), device).nets

    def maps(nets, device, card_ms=None):
        """The maps of ``images`` in batches; with ``card_ms``, each batch's
        card time appended to it."""
        out = []
        for start in range(0, len(images), SALIENCY["batch"]):
            batch = torch.from_numpy(images[start:start + SALIENCY["batch"]]).to(device)
            if card_ms is None:
                out.append(pixel_importance.saliency(nets, batch, axis.to(device)).cpu().numpy())
                continue
            begin, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            begin.record()
            grads = pixel_importance.saliency(nets, batch, axis.to(device))
            end.record()
            end.synchronize()
            card_ms.append(begin.elapsed_time(end))
            out.append(grads.cpu().numpy())
        return np.concatenate(out)

    counters = _kernel_counters()
    for c in counters:
        c.reset()
    card_ms = []
    cpu = maps(nets_of("float32", "cpu"), "cpu")
    card_f32 = nets_of("float32", "cuda")

    def against_cpu(card):
        diff = np.abs(card - cpu)
        off = diff > 1e-4 * np.abs(cpu).max()
        return {"max_of_max": float(diff.max() / np.abs(cpu).max()),
                "rms_share": float(np.sqrt(np.mean(diff ** 2)) / np.sqrt(np.mean(cpu ** 2))),
                "pixels_off_share": float(off.mean()),
                "frames_with_pixels_off": int(off.any(axis=(1, 2)).sum())}

    err = against_cpu(maps(card_f32, "cuda", card_ms))
    # The upper readings, which the bars sit below: the same comparison with
    # the card's products rounded further, TF32 on and bfloat16 compute.
    upper = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        upper["tf32"] = against_cpu(maps(card_f32, "cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    upper["bfloat16"] = against_cpu(maps(nets_of("bfloat16", "cuda"), "cuda"))

    out = os.path.join(inputs["root"], "saliency.mp4")
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    with _platform("cuda"):
        rc = pixel_importance.main([
            f"--in_video={paths['images']}", f"--out_video={out}",
            f"--forward_axis_json={paths['forward']}",
            f"--net_settings_json={inputs['settings']['float32']}",
            f"--in_model_weights={','.join(checkpoints)}", "--convert_to_yuv=1",
            f"--crop_top={ROAD['crop']['crop_top']}",
            f"--crop_bottom={ROAD['crop']['crop_bottom']}",
            f"--batch_size={SALIENCY['batch']}"])
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    _no_kernel_launches("saliency", counters)
    written, shape = video_frames_and_shape(out)
    crop_h = ROAD["height"] - ROAD["crop"]["crop_top"] - ROAD["crop"]["crop_bottom"]
    row = {"frames_compared": len(cpu), "card_against_cpu": err,
           "upper_readings_against_cpu": upper,
           "bars": {k: SALIENCY[k] for k in ("rms_share", "pixels_off_share")},
           "map_max": float(np.abs(cpu).max()),
           "card_ms_per_batch_median": statistics.median(card_ms),
           "cli": {"rc": rc, "frames": written, "seconds": seconds,
                   "frames_per_s": written / seconds, "peak_device_mib": peak / 2**20}}
    print(f"saliency (PilotNet x{PILOTNET['nets']}, float32, batch {SALIENCY['batch']}): "
          f"{json.dumps(row)}", flush=True)
    if not (rc == 0 and err["rms_share"] <= SALIENCY["rms_share"]
            and err["pixels_off_share"] <= SALIENCY["pixels_off_share"] and row["map_max"] > 0
            and written == ROAD["frames"] and shape == (crop_h, ROAD["width"], 3)):
        raise AssertionError(f"saliency: {json.dumps(row)}")
    return row


def run_dense_ba(captured) -> dict:
    """12g: the BA oracle, bundle_adjust(solver="dense"), on the card in
    float64, on the local-BA problem of the parallax ride's last keyframe
    (captured in phase 7), against the Schur path within DENSE_BA_BARS and
    equal inlier masks; the dense Jacobian's bytes reckoned first, each
    solve's ms and the dense solve's peak device memory."""
    import torch

    from pilotguru_tpu_torch.vo import ba

    problem, kwargs = captured["ba"]
    problem = ba.BAProblem(*(t.to(torch.float64) if t is not None and t.is_floating_point()
                             else t for t in problem))
    k, m, o = problem.poses6.shape[0], problem.points.shape[0], problem.obs_valid.shape[0]
    dim, rows = 6 * k + 3 * m, 2 * o + 7
    reckoned = {"poses": k, "points": m, "observations": o, "parameters": dim,
                "residuals": rows, "jacobian_mib": rows * dim * 8 / 2**20,
                "normal_matrix_mib": dim * dim * 8 / 2**20}
    print(f"dense BA oracle on the parallax ride's last local BA: {json.dumps(reckoned)}",
          flush=True)
    results, ms = {}, {}
    for solver in ("schur", "dense", "schur", "dense"):  # the second of each is timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        results[solver] = ba.bundle_adjust(problem, solver=solver, **kwargs)
        torch.cuda.synchronize()
        ms[solver] = 1e3 * (time.perf_counter() - start)
        if solver == "dense":
            peak = torch.cuda.max_memory_allocated()
    schur, dense = results["schur"], results["dense"]
    valid = problem.point_valid
    row = {**reckoned, "schur_ms": ms["schur"], "dense_ms": ms["dense"],
           "dense_peak_device_mib": peak / 2**20,
           "poses_abs": float((schur.poses6 - dense.poses6).abs().max()),
           "points_abs": float((schur.points - dense.points)[valid].abs().max()),
           "inliers_differ": int((schur.obs_inliers != dense.obs_inliers).sum()),
           "inliers": int(schur.obs_inliers.sum()),
           "losses": [float(schur.final_loss), float(dense.final_loss)], "bars": DENSE_BA_BARS}
    print(f"dense BA oracle against Schur, card float64: {json.dumps(row)}", flush=True)
    if not (row["poses_abs"] <= DENSE_BA_BARS["poses_abs"]
            and row["points_abs"] <= DENSE_BA_BARS["points_abs"] and row["inliers_differ"] == 0):
        raise AssertionError(f"dense BA oracle: {json.dumps(row)}")
    return row


def run_map_resume(captured, frames_u8, parallax_trajectory, out_dir) -> dict:
    """12h: a fresh tracker on the card loads the map phase 7 saved after
    frame MAP_SAVE_FRAME and tracks the rest of the ride: every frame OK,
    K1 and K2 once a frame, the joined trajectory within TRUTH_BARS; whether
    it equals the uninterrupted run's is reported."""
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory, write_trajectory
    from pilotguru_tpu_torch.vo import map_io, pipeline, tracking

    saved = captured["map"]
    tracker = pipeline.tracker_from_settings(ride_settings(), device="cuda",
                                             track_chunk_frames=0)
    start = time.perf_counter()
    map_io.load_tracker_map(saved["path"], tracker)
    load_ms = 1e3 * (time.perf_counter() - start)
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    states = []
    start = time.perf_counter()
    for i in range(MAP_SAVE_FRAME + 1, len(frames_u8)):
        feats = tracker.features(frames_u8[i])
        states.append(tracker.process_features(*feats[:3], i, int(round(i * 1e6 / 30.0)),
                                               *feats[3:]))
    seconds = time.perf_counter() - start
    launches = {c.name: c.launches for c in counters}
    tracker.finalize()
    joined = pipeline.trajectory_from_tracker(tracker)
    joined = joined and pipeline.postprocess_segment(joined, 0, "cuda")
    if joined is None:
        raise AssertionError(f"map checkpoint: no trajectory after resuming ({states})")
    path = os.path.join(out_dir, "trajectory-resumed.json")
    write_trajectory(joined, path)
    traj = read_trajectory(path)
    errors = trajectory_errors(traj, ride_pose)
    with open(path, "rb") as a, open(parallax_trajectory, "rb") as b:
        same = a.read() == b.read()
    uninterrupted = read_trajectory(parallax_trajectory)
    row = {"saved_after_frame": MAP_SAVE_FRAME, "map_bytes": saved["bytes"],
           "save_ms": saved["save_ms"], "sync_before_save_ms": saved["sync_ms"],
           "load_ms": load_ms, "frames_resumed": len(states),
           "ok_frames": states.count(tracking.OK), "frames_per_s": len(states) / seconds,
           "launches": launches, "joined_frames": len(traj), "against_truth": errors,
           "bars": TRUTH_BARS, "equals_uninterrupted": same,
           "centre_gap_to_uninterrupted": float(np.abs(
               traj.translations - uninterrupted.translations).max())
           if len(traj) == len(uninterrupted) else None}
    print(f"map checkpoint (phase 7 saved after frame {MAP_SAVE_FRAME}, resumed on the "
          f"card): {json.dumps(row)}", flush=True)
    want = {"fast_nms": len(states), "gather_patches": len(states), "gather_blurred_patches": 0}
    over = {k: v for k, v in TRUTH_BARS.items() if errors[k] > v}
    if (saved["state"] != tracking.OK or row["ok_frames"] != len(states)
            or launches != want or len(traj) != len(frames_u8) or over):
        raise AssertionError(f"map checkpoint: {json.dumps(row)}")
    return launches, row


def run_visualize(root, golden_card_trajectory) -> tuple:
    """12i: the VO CLI on the golden mp4 with --visualize and
    --visualize_live_port=0: the trajectory equal to phase 10's to the
    byte, visualize-0000.mp4 with every frame, /state.json, / and one frame
    fetched from the tracking loop at frame 60; then
    --output_per_segment_videos: the segment video holds the OK frames, the
    JSON's ids index it, and its poses are phase 10's from the first OK
    frame on. K1 and K2 once a frame in both runs. Returns (launches,
    row)."""
    import urllib.request

    from pilotguru_tpu_torch.cli import optical_trajectories
    from pilotguru_tpu_torch.formats.trajectory import read_trajectory
    from pilotguru_tpu_torch.vo import viewer

    def get(url):
        with urllib.request.urlopen(url, timeout=10) as response:
            return response.status, response.headers.get("Content-Type"), response.read()

    fetched = {}
    publish_state = viewer.LiveViewer.publish_state

    def publish_and_fetch(self, tracker, frame_id, state, inliers):
        publish_state(self, tracker, frame_id, state, inliers)
        if frame_id == 60:
            base = f"http://127.0.0.1:{self.port}"
            fetched.update(state=get(base + "/state.json"), frame=get(base + "/frame.jpg"),
                           page=get(base + "/"))

    out = os.path.join(root, "visualize")
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    viewer.LiveViewer.publish_state = publish_and_fetch
    start = time.perf_counter()
    try:
        with _platform("cuda"):
            rc = optical_trajectories.main(golden_cli_argv(out) + [
                "--visualize", "--visualize_live_port=0"])
    finally:
        viewer.LiveViewer.publish_state = publish_state
    seconds = time.perf_counter() - start
    files = sorted(os.listdir(out))
    with open(os.path.join(out, "trajectory-0000.json"), "rb") as a, \
            open(golden_card_trajectory, "rb") as b:
        same = a.read() == b.read()
    overlay_frames, _ = video_frames_and_shape(os.path.join(out, "visualize-0000.mp4"))
    state = json.loads(fetched["state"][2])

    seg_out = os.path.join(root, "segment-videos")
    with _platform("cuda"):
        rc_seg = optical_trajectories.main(golden_cli_argv(seg_out) +
                                           ["--output_per_segment_videos"])
    launches = {c.name: c.launches for c in counters}  # both runs
    seg_files = sorted(os.listdir(seg_out))
    seg = read_trajectory(os.path.join(seg_out, "trajectory-0000.json"))
    seg_frames, _ = video_frames_and_shape(os.path.join(seg_out, "trajectory-0000.mp4"))
    # The segment's entries are phase 10's from the first OK frame on.
    plain = read_trajectory(golden_card_trajectory)
    tail = slice(len(plain) - len(seg), None)
    same_poses = (np.array_equal(seg.translations, plain.translations[tail])
                  and np.array_equal(seg.rotations, plain.rotations[tail])
                  and np.array_equal(seg.time_usec, plain.time_usec[tail]))
    n = len(plain)
    row = {"seconds": seconds, "frames_per_s": n / seconds, "files": files,
           "overlay_frames": overlay_frames, "trajectory_equals_phase10": same,
           "launches": launches, "state_at_frame_60": {k: state[k] for k in (
               "frame_id", "state", "inliers", "map_points", "keyframes")},
           "frame_jpeg_bytes": len(fetched["frame"][2]),
           "segment_videos": {"files": seg_files, "segment_video_frames": seg_frames,
                              "json_entries": len(seg), "first_id": int(seg.frame_id[0]),
                              "poses_equal_phase10_from_first_ok": same_poses}}
    print(f"VO CLI visualization on the card: {json.dumps(row)}", flush=True)
    want = {"fast_nms": 2 * n, "gather_patches": 2 * n, "gather_blurred_patches": 0}
    if not (rc == 0 and rc_seg == 0 and same and launches == want
            and files == ["trajectory-0000.json", "visualize-0000.mp4"] and overlay_frames == n
            and fetched["state"][0] == 200 and state["frame_id"] == 60
            and fetched["frame"][2][:2] == b"\xff\xd8" and b"stream.mjpg" in fetched["page"][2]
            and seg_files == ["trajectory-0000.json", "trajectory-0000.mp4"]
            and np.array_equal(seg.frame_id, np.arange(seg_frames)) and same_poses):
        raise AssertionError(f"VO CLI visualization: {json.dumps(row)}")
    return launches, row


def run_host_tools(inputs, reference_json) -> dict:
    """12j: render_frame_numbers and render_motion over the road ride and
    calibrate on board.mp4, on the card's machine (host only: no kernel
    runs); calibrate within CALIBRATE_BAR of the golden YAML."""
    from pilotguru_tpu_torch.cli import calibrate, render_frame_numbers, render_motion
    from pilotguru_tpu_torch.formats import json_io
    from pilotguru_tpu_torch.video.png import write_png
    from pilotguru_tpu_torch.vo.camera import read_camera_settings

    root, paths = inputs["root"], inputs["paths"]
    ids, steering = _steering(reference_json)
    json_io.write_json({"velocities": [{"frame_id": int(i), "speed_m_s": float(road_speed(
        i / ROAD["fps"]))} for i in ids]}, os.path.join(root, "road-velocities.json"))
    yy, xx = np.mgrid[:64, :64]
    ring = np.abs(np.hypot(yy - 31.5, xx - 31.5) - 26) < 3
    wheel = np.zeros((64, 64, 3), np.uint8)
    wheel[ring] = (200, 200, 200)
    wheel[28:36, 4:60] = (200, 200, 200)
    write_png(os.path.join(root, "wheel.png"), wheel)
    counters = _kernel_counters()
    for c in counters:
        c.reset()
    times, row = {}, {}
    _run_cli(times, "render_frame_numbers", render_frame_numbers.main, [
        f"--in_video={paths['images']}", f"--out_video={root}/numbered.mp4",
        "--frames_to_skip=10", "--max_out_frames=100", "--output_every_n_frames=2"])
    _run_cli(times, "render_motion", render_motion.main, [
        f"--in_video={paths['images']}", f"--steering_left_json={reference_json}",
        f"--velocities_json_left={root}/road-velocities.json",
        f"--steering_right_json={reference_json}", "--steering_right_scale=45",
        f"--steering_wheel={root}/wheel.png", f"--out_video={root}/motion.mp4",
        "--target_video_height=270", "--target_video_width=480", "--max_out_frames=200"])
    _run_cli(times, "calibrate", calibrate.main, [
        f"--input={os.path.join(REPO_DIR, 'tests', 'golden', 'inputs', 'board.mp4')}",
        "--board_side_width=7", "--board_side_height=5", "--square_size=0.03",
        f"--out_file={root}/camera_calib.yaml"])
    _no_kernel_launches("host tools", counters)
    numbered, _ = video_frames_and_shape(f"{root}/numbered.mp4")
    motion, motion_shape = video_frames_and_shape(f"{root}/motion.mp4")
    golden_yaml = os.path.join(REPO_DIR, "tests", "golden", "expected", "camera_calib.yaml")
    got, want = read_camera_settings(f"{root}/camera_calib.yaml"), read_camera_settings(golden_yaml)
    rel = {k: abs(getattr(got, k) - getattr(want, k)) / max(abs(getattr(want, k)), 1e-12)
           for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")}
    with open(f"{root}/camera_calib.yaml", "rb") as a, open(golden_yaml, "rb") as b:
        byte_equal = a.read() == b.read()
    row = {"seconds": times, "numbered_frames": numbered,
           "motion_frames": motion, "motion_shape": list(motion_shape),
           "calibrate_relative_to_golden": rel, "calibrate_byte_equal": byte_equal,
           "bar": CALIBRATE_BAR}
    print(f"host tools on the card's machine: {json.dumps(row)}", flush=True)
    if not (numbered == 100 and motion == 200 and motion_shape == (270 + 64, 480, 3)
            and max(rel.values()) <= CALIBRATE_BAR):
        raise AssertionError(f"host tools: {json.dumps(row)}")
    return row

def run_slice_phases(frame_rows, captured, ride, parallax_trajectory, out_dir):
    """Phases 12e to 12h and 12j (12i runs in the golden lane). Returns the
    K1 / K2 / K3 launches of 12h's VO path and the rows."""
    inputs = frame_rows["inputs"]
    reference = os.path.join(inputs["root"], "predict-card-float32.json")
    rows, launches = {}, {}
    rows["predict_live"] = run_predict_live(inputs, reference)
    rows["saliency"] = run_saliency(inputs)
    rows["dense_ba"] = run_dense_ba(captured)
    launches["map_resume"], rows["map_resume"] = run_map_resume(
        captured, ride, parallax_trajectory, out_dir)
    rows["host_tools"] = run_host_tools(inputs, reference)
    return launches, rows


def check_training(out, times, cpu_seconds) -> dict:
    """The train CLI's card runs against the CPU's float32 run (within
    TRAIN_F32_BARS; whether the markers and lr_scale agree is reported),
    the card's float32 run again equal to the first to the bit (training
    asks cuDNN for its deterministic algorithms), and the card's bfloat16
    run against its float32 run (finite, falling, within TRAIN_BF16_BAR);
    then the first step alone (check_train_step)."""
    f32 = compare_training(out["train_card_float32"], out["train_cpu"])
    again = compare_training(out["train_card_float32_again"], out["train_card_float32"])
    bf16 = compare_training(out["train_card_bfloat16"], out["train_card_float32"])
    bf16_train = _train_log(out["train_card_bfloat16"])
    row = {"card_float32_against_cpu": f32, "bars_float32": TRAIN_F32_BARS,
           "card_float32_again": {k: again[k] for k in ("loss_rel", "param_abs",
                                                        "markers_and_lr_scale_equal")},
           "card_bfloat16_against_card_float32": bf16, "bar_bfloat16": TRAIN_BF16_BAR,
           "bfloat16_train_loss_by_epoch": [e["train_loss"] for e in bf16_train],
           "seconds": {"card float32": times["train float32"],
                       "card bfloat16": times["train bfloat16"], "cpu float32": cpu_seconds}}
    print(f"train CLI, PilotNet x{TRAIN['nets']} on the road dataset: {json.dumps(row)}",
          flush=True)
    losses = row["bfloat16_train_loss_by_epoch"]
    if not (f32["loss_rel"] <= TRAIN_F32_BARS["loss_rel"]
            and f32["param_abs"] <= TRAIN_F32_BARS["param_abs"]
            and again["loss_rel"] == 0.0 and again["param_abs"] == 0.0
            and np.isfinite(losses).all() and losses[-1] < losses[0]
            and bf16["loss_rel"] <= TRAIN_BF16_BAR):
        raise AssertionError(f"train CLI on the card: over the bars: {json.dumps(row)}")
    row["first_step"] = check_train_step(out["data_card"])
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    import pilotguru_tpu_torch  # noqa: F401  (precision policy)
    from pilotguru_tpu_torch import cuda_lib
    from pilotguru_tpu_torch.ml import bn_relu_kernel, conv_kernel
    from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel

    started = time.perf_counter()

    def mark(phase):
        print(f"-- {phase} starts at {time.perf_counter() - started:.1f} s", flush=True)

    # TF32 moves the ride's trajectory by less than RANSAC draws do (PERF.md),
    # so the truth bars cannot see it: hold the policy itself.
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on; the port keeps float32 products full float32")

    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    build = cuda_lib.build()
    for module in (fast_kernel, patch_kernel, bn_relu_kernel, conv_kernel):
        for stem in module.SIGNATURES:
            module.library(stem)
    print(f"built {', '.join(p.name for p in build.paths)} in {build.seconds:.2f} s",
          flush=True)
    if build.log.strip():
        print(build.log.strip(), flush=True)

    # Every kernel against its plain version first; their timings (profiler
    # sessions) come after the paths whose frames/s the smoke reports.
    rng = np.random.default_rng(0)
    k1 = check_fast_kernel(rng)
    k2 = check_patch_kernel(rng)
    k3 = check_blur_patch_kernel(rng)
    bn = check_bn_relu_kernel()
    conv = check_conv_bwd_kernel()

    t0 = time.perf_counter()
    ride = list(render_ride())
    loop_ride = list(render_loop_ride())
    print(f"rendered {len(ride)} + {len(loop_ride)} frames {RIDE_W}x{RIDE_H} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_extractor_cuda_vs_cpu(ride[0], "blur_then_gather")
    check_extractor_cuda_vs_cpu(loop_ride[0], "fused")
    mark("the seed guard")
    card_lost = run_seed_guard(ride)

    out_dir = tempfile.mkdtemp(prefix="pg_chip_smoke_")
    lanes, golden_cpu, cpu_seed_guard = [], None, None
    try:
        # Phase 7 and 7c's parallax ride have the card alone: their frames/s
        # are the pair this smoke compares.
        mark("phase 7")
        with capture_parallax_state(os.path.join(out_dir, "map.npz")) as captured:
            parallax, _, parallax_row = run_path(
                "parallax path", ride, os.path.join(out_dir, "parallax"),
                "blur_then_gather", PARALLAX_LAUNCHES, ride_pose, TRUTH_BARS,
                untimed=captured,
            )
        parallax_trajectory = os.path.join(out_dir, "parallax", "trajectory-0000.json")
        mark("7c's parallax ride")
        chunked_parallax = run_default_parallax(ride, out_dir, parallax_row)
        decoder = mp4_decoder(GOLDEN_VIDEO)
        print(f"mp4 decoder on this machine (video/io.py's routes): {decoder or 'none'}; the "
              f"golden-video phases {'run' if decoder else 'are skipped'}", flush=True)

        mark("the lanes")
        loop_lane = Lane("phase 8 (the loop ride frame by frame)", run_path,
                         "loop ride", loop_ride, os.path.join(out_dir, "loop"), "fused",
                         LOOP_LAUNCHES, loop_pose, LOOP_TRUTH_BARS, period=LOOP_PERIOD,
                         expect_loops=True)
        lanes.append(loop_lane)
        loop_chunked_lane = Lane("7c's loop ride", run_default_loop, loop_ride, out_dir)
        lanes.append(loop_chunked_lane)
        cli_lane = Lane("the VO CLI on the image list, the golden mp4 frame by frame and 9b",
                        run_cli_lane, ride, out_dir, chunked_parallax["trajectory"],
                        chunked_parallax["frames_per_s"], decoder)
        lanes.append(cli_lane)
        if decoder:
            golden_lane = Lane("the golden mp4 at the CLI's defaults and 12i", run_golden_lane,
                               out_dir)
            lanes.append(golden_lane)
            golden_cpu = start_golden_cpu(os.path.join(out_dir, "golden_cpu"))
        else:
            print("no mp4 decoder: the visualization phase is skipped", flush=True)
        host_lane = Lane("fit_motion, the corpus, the annotation and the sharded paths",
                         run_host_lane, parallax_trajectory, ride)
        cpu_seed_guard = start_cpu_seed_guard()
        lanes.append(host_lane)

        mark("the frame-input phases (beside the lanes)")
        frame_rows = run_frame_input_phases(os.path.join(out_dir, "frame_input"))
        mark("phases 12e to 12h and 12j (beside the lanes)")
        slice_launches, _ = run_slice_phases(frame_rows, captured, ride, parallax_trajectory,
                                             out_dir)

        loop, _, loop_row = loop_lane.result()
        chunked_loop = loop_chunked_lane.result()[2]
        print_default_against_per_frame("loop", chunked_loop, loop_row, 8,
                                        "both in lanes, at once")
        vo_cli, golden_per_frame, process_frame_launches = cli_lane.result()
        if decoder:
            _, (slice_launches["visualize"], _) = golden_lane.result()
            cpu_seconds = finish_cpu_companion(golden_cpu)
            golden_cpu = None
            check_golden_against_cpu(*golden_per_frame, os.path.join(out_dir, "golden_cpu"),
                                     cpu_seconds)
        sharded_launches = host_lane.result()
        cpu_lost = finish_cpu_companion(cpu_seed_guard)["lost"]
        cpu_seed_guard = None
        print(f"seed guard: first lost frame on the card {card_lost}, on the CPU in float32 "
              f"with one thread {cpu_lost}", flush=True)
        lanes = []
        mark("the forward pass's and the train step's timings")
        forward_timings(frame_rows["inputs"]["checkpoints"])
        bn_before = bn_relu_kernel.COUNTER.launches + bn_relu_kernel.BACKWARD_COUNTER.launches
        conv_before = conv_kernel.COUNTER.launches + conv_kernel.BACKWARD_COUNTER.launches
        train_throughput()
        bn_launches = (bn_relu_kernel.COUNTER.launches
                       + bn_relu_kernel.BACKWARD_COUNTER.launches - bn_before)
        conv_launches = (conv_kernel.COUNTER.launches
                         + conv_kernel.BACKWARD_COUNTER.launches - conv_before)
        mark("the kernel timings")
    finally:
        for lane in lanes:
            lane.stop()
        for child in (golden_cpu, cpu_seed_guard):
            if child is not None:
                child.kill()
                child.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)

    (k1, k1_levels), (k2, k2_levels) = time_fast_kernel(k1, loop_ride[0]), time_patch_kernel(k2)
    k3, k3_levels = time_blur_patch_kernel(k3)
    bn_rows = time_bn_relu_kernel()
    conv_rows = time_conv_bwd_kernel()
    torch.cuda.synchronize()

    def entry(name, source, replaces, shape, row, one_level=None):
        """``row``: the kernel at the shape the paths give it; ``one_level``:
        its one-level call at level 0, where the paths use the all-level one."""
        launches = {"parallax": parallax[name], "loop": loop[name],
                    "parallax_chunked": chunked_parallax["launches"][name],
                    "loop_chunked": chunked_loop["launches"][name],
                    "vo_cli": vo_cli["launches"][name],
                    "process_frame": process_frame_launches[name],
                    "sharded_prefetch": sharded_launches[name],
                    **{path: counts[name] for path, counts in slice_launches.items()}}
        out = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "shape": shape, "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        }
        if one_level is not None:
            out["one_level"] = {k: one_level.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by", "library_ms")}
        return out

    print(f"card for the numbers below: {card}", flush=True)
    print(json.dumps({"kernels": [
        entry("fast_nms", "pilotguru_tpu_torch/csrc/fast_nms.cu",
              "pilotguru_tpu/vo/fast_pallas.py:140", "8 levels of 720x1280, one launch",
              k1_levels, k1[0]),
        entry("gather_patches", "pilotguru_tpu_torch/csrc/patch_gather.cu",
              "pilotguru_tpu/vo/patch_pallas.py:256", "8 levels of 720x1280, K=2000, one launch",
              k2_levels, k2),
        entry("gather_blurred_patches", "pilotguru_tpu_torch/csrc/blur_patch_gather.cu",
              "pilotguru_tpu/vo/patch_pallas.py:176",
              "8 levels of 720x1280, K=2000, one launch", k3_levels, k3[0]),
        {"name": "bn_relu", "route": "cuda", "source": "pilotguru_tpu_torch/csrc/bn_relu.cuh",
         "replaces": None,  # no TPU kernel: XLA fuses the JAX package's expression
         "launches": bn_launches, "launches_by_path": {"train_throughput": bn_launches},
         "shape": f"the train-mode batch norms of a PilotNet x{BN_NETS[0]} step at batch "
                  f"{BN_BATCH}, forward and backward",
         "max_abs_err": bn, **{k: bn_rows[0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "design_ms", "replaced_ms")},
         "x12": {k: bn_rows[1][k] for k in (
             "ms", "plain_ms", "bound_ms", "design_ms", "replaced_ms")}},
        {"name": "conv_bwd", "route": "cuda", "source": "pilotguru_tpu_torch/csrc/conv_bwd.cuh",
         "replaces": None,  # no TPU kernel: XLA differentiates the JAX package's convolutions
         "launches": conv_launches, "launches_by_path": {"train_throughput": conv_launches},
         "shape": f"the convs of a PilotNet x{CONV_CELLS[0][1]} step at batch {BN_BATCH}, dgrad "
                  "and wgrad",
         "max_abs_err": conv,
         **{k: conv_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
         "by_cell": [{k: c[k] for k in ("net", "nets", "ms", "plain_ms", "bound_ms", "library_ms")}
                     for c in conv_rows]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
