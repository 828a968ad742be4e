"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
nothing of JAX, and tests/conftest.py does, so on the card (which has no
JAX) run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel
from pilotguru_tpu_torch.vo.fast_kernel import fast_nms, fast_nms_levels, fast_nms_plain
from pilotguru_tpu_torch.vo.features import (
    extract_orb_features,
    level_shapes,
    pyramid_level_budgets,
    resize_linear,
)
from pilotguru_tpu_torch.vo.patch_kernel import (
    gather_blurred_patches,
    gather_blurred_patches_levels,
    gather_blurred_patches_plain,
    gather_patches,
    gather_patches_levels,
    gather_patches_plain,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(720, 1280), (201, 357), (1080, 1920), (33, 40)])
def test_fast_kernel_matches_plain(cuda, shape):
    img = np.random.default_rng(2).uniform(0, 1, size=shape).astype(np.float32)
    img = torch.from_numpy(img).to(cuda)
    raw, nms = fast_nms(img)
    want_raw, want_nms = fast_nms_plain(img)
    torch.cuda.synchronize()
    assert torch.equal(raw, want_raw)  # same tap order: bit-identical
    assert torch.equal(nms, want_nms)


def _pyramid(cuda, seed, num_levels=8):
    img = np.random.default_rng(seed).uniform(0, 1, size=(720, 1280)).astype(np.float32)
    img = torch.from_numpy(img).to(cuda)
    shapes = level_shapes(720, 1280, num_levels, 1.2)
    return [img] + [resize_linear(img, h, w) for h, w in shapes[1:]]


@pytest.mark.cuda
@pytest.mark.parametrize("num_levels", [1, 3, 8])
def test_fast_levels_kernel_matches_plain(cuda, num_levels):
    """One launch over the pyramid equals the plain version level by level,
    bit for bit, and counts as one launch."""
    images = _pyramid(cuda, 3, num_levels)
    fast_kernel.COUNTER.reset()
    got = fast_nms_levels(images)
    torch.cuda.synchronize()
    assert fast_kernel.COUNTER.launches == 1
    for (raw, nms), img in zip(got, images):
        want_raw, want_nms = fast_nms_plain(img)
        assert torch.equal(raw, want_raw)
        assert torch.equal(nms, want_nms)


@pytest.mark.cuda
def test_patch_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.uniform(0, 1, size=(720, 1280)).astype(np.float32)).to(cuda)
    yx = np.stack([rng.integers(-3, 723, 434), rng.integers(-3, 1283, 434)], axis=1)
    yx = torch.from_numpy(yx.astype(np.int32)).to(cuda)
    assert torch.equal(gather_patches(img, yx), gather_patches_plain(img, yx))


@pytest.mark.cuda
@pytest.mark.parametrize("num_levels", [1, 3, 8])
def test_patch_levels_kernel_matches_plain(cuda, num_levels):
    """K2's one launch over the pyramid at the extractor's per-level budgets,
    plus keypoints within 19 px of each border, the four corners, starts
    outside the image (negative ones clamp to 0) and one level without any,
    equals the plain version level by level, bit for bit."""
    rng = np.random.default_rng(10)
    images = _pyramid(cuda, 5, num_levels)
    budgets = pyramid_level_budgets(2000, 8, 1.2)[:num_levels]
    yx = []
    for img, k in zip(images, budgets):
        h, w = img.shape
        pts = np.concatenate([
            np.stack([rng.integers(0, h, k), rng.integers(0, w, k)], axis=1),
            np.stack([rng.integers(0, 19, 8), rng.integers(0, w, 8)], axis=1),
            np.stack([rng.integers(h - 19, h, 8), rng.integers(w - 19, w, 8)], axis=1),
            np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1], [-5, -7], [h + 3, w]]),
        ])
        yx.append(torch.from_numpy(pts.astype(np.int32)).to(cuda))
    if num_levels > 1:
        yx[1] = yx[1][:0]
    patch_kernel.COUNTER.reset()
    got = gather_patches_levels(images, yx)
    torch.cuda.synchronize()
    assert patch_kernel.COUNTER.launches == 1
    for patches, img, level_yx in zip(got, images, yx):
        assert torch.equal(patches, gather_patches_plain(img, level_yx))


@pytest.mark.cuda
def test_patch_kernel_refuses_other_radii(cuda):
    """K2 is compiled for radius 19; the wrapper raises for anything else."""
    img = torch.zeros((64, 64), device=cuda)
    yx = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="built for radius 19"):
        gather_patches(img, yx, radius=5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(720, 1280), (201, 357), (32, 40)])
def test_blur_patch_kernel_matches_plain(cuda, shape):
    """K3 equals its plain version bit for bit (same taps, same order, no
    FMA) on random keypoints, keypoints within 27 px of each border and the
    four corners."""
    rng = np.random.default_rng(8)
    h, w = shape
    img = torch.from_numpy(rng.uniform(0, 1, size=shape).astype(np.float32)).to(cuda)
    yx = np.concatenate([
        np.stack([rng.integers(0, h, 434), rng.integers(0, w, 434)], axis=1),
        np.stack([rng.integers(0, min(27, h), 8), rng.integers(0, w, 8)], axis=1),
        np.stack([rng.integers(max(h - 27, 0), h, 8), rng.integers(0, w, 8)], axis=1),
        np.stack([rng.integers(0, h, 8), rng.integers(0, min(27, w), 8)], axis=1),
        np.stack([rng.integers(0, h, 8), rng.integers(max(w - 27, 0), w, 8)], axis=1),
        np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]]),
    ])
    yx = torch.from_numpy(yx.astype(np.int32)).to(cuda)
    assert torch.equal(gather_blurred_patches(img, yx), gather_blurred_patches_plain(img, yx))


@pytest.mark.cuda
@pytest.mark.parametrize("num_levels", [1, 3, 8])
def test_blur_patch_levels_kernel_matches_plain(cuda, num_levels):
    """One launch over the pyramid at the extractor's per-level budgets,
    plus near-border and corner keypoints and one level without any, equals
    the plain version level by level, bit for bit."""
    rng = np.random.default_rng(9)
    images = _pyramid(cuda, 4, num_levels)
    budgets = pyramid_level_budgets(2000, 8, 1.2)[:num_levels]
    yx = []
    for img, k in zip(images, budgets):
        h, w = img.shape
        pts = np.concatenate([
            np.stack([rng.integers(0, h, k), rng.integers(0, w, k)], axis=1),
            np.stack([rng.integers(0, 27, 8), rng.integers(0, w, 8)], axis=1),
            np.stack([rng.integers(h - 27, h, 8), rng.integers(w - 27, w, 8)], axis=1),
            np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]]),
        ])
        yx.append(torch.from_numpy(pts.astype(np.int32)).to(cuda))
    if num_levels > 1:
        yx[1] = yx[1][:0]
    patch_kernel.BLUR_COUNTER.reset()
    got = gather_blurred_patches_levels(images, yx)
    torch.cuda.synchronize()
    assert patch_kernel.BLUR_COUNTER.launches == 1
    for patches, img, level_yx in zip(got, images, yx):
        assert torch.equal(patches, gather_blurred_patches_plain(img, level_yx))


@pytest.mark.cuda
def test_blur_patch_kernel_refuses_other_shapes(cuda):
    """K3 is compiled for radius 19 under the 17-tap blur; the wrapper
    raises for anything else instead of computing something else."""
    img = torch.zeros((64, 64), device=cuda)
    yx = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="built for radius 19"):
        gather_blurred_patches(img, yx, radius=15)
    with pytest.raises(ValueError, match="built for radius 19"):
        gather_blurred_patches_levels([img], [yx], sigma=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("patch_impl", ["blur_then_gather", "fused"])
def test_extractor_cuda_matches_cpu(cuda, patch_impl):
    """Every extractor stage is device-independent except the orientation
    moment sums (reduction order), which can flip a descriptor only for an
    angle at a steering-bin edge."""
    rng = np.random.default_rng(7)
    img = np.zeros((360, 640), np.float32)
    for _ in range(300):
        y, x = rng.integers(0, 350), rng.integers(0, 630)
        img[y : y + rng.integers(3, 12), x : x + rng.integers(3, 12)] = rng.uniform()
    cpu = extract_orb_features(torch.from_numpy(img), num_levels=4, total_budget=800,
                               patch_impl=patch_impl)
    gpu = extract_orb_features(torch.from_numpy(img).to(cuda), num_levels=4,
                               total_budget=800, patch_impl=patch_impl)
    assert torch.equal(cpu.valid, gpu.valid.cpu())
    assert torch.equal(cpu.level, gpu.level.cpu())
    assert torch.equal(cpu.xy, gpu.xy.cpu())
    torch.testing.assert_close(cpu.angle, gpu.angle.cpu(), atol=1e-5, rtol=0)
    same = (cpu.descriptors == gpu.descriptors.cpu()).all(dim=1)
    assert float(same[cpu.valid].float().mean()) >= 0.995


# ---- the data path (no kernels of its own): results on the card, float64 as the CPU --------


@pytest.mark.cuda
def test_interval_averages_and_smoothing_stay_on_the_card(cuda):
    from pilotguru_tpu_torch.timeseries.interval_average import annotate_frames_values
    from pilotguru_tpu_torch.timeseries.smoothing import smooth_quaternion_sequence

    rng = np.random.default_rng(3)
    times = 1_000_000 + np.cumsum(rng.integers(1000, 20_000, 5000)).astype(np.int64)
    values = rng.normal(size=times.size)
    frames = np.arange(times[0] - 50_000, times[-1] + 50_000, 33_333).astype(np.int64)
    got, valid = annotate_frames_values(times, values, frames, device=cuda)
    want, want_valid = annotate_frames_values(times, values, frames, device="cpu")
    assert got.is_cuda and valid.is_cuda
    assert torch.equal(valid.cpu(), want_valid)
    ok = want_valid.numpy()
    np.testing.assert_allclose(got.cpu().numpy()[ok], want.numpy()[ok], rtol=0, atol=1e-12)
    q = rng.normal(size=(500, 4))
    smoothed = smooth_quaternion_sequence(q, 2, device=cuda)
    assert smoothed.is_cuda
    torch.testing.assert_close(smoothed.cpu(), smooth_quaternion_sequence(q, 2, device="cpu"),
                               rtol=0, atol=1e-14)


@pytest.mark.cuda
def test_interpolate_in_float64_follows_the_cpu(cuda):
    from pilotguru_tpu_torch.calib.interpolate import (
        InterpolationSettings,
        interpolate_gps_velocities,
    )

    import chip_smoke

    arrays, _ = chip_smoke.make_imu_ride(120.0, seed=5)
    frame_t = np.arange(arrays[0][0], arrays[0][-1], 1e6 / 30).astype(np.int64)
    settings = InterpolationSettings(l1_weight=1.0, iters=300)
    got = interpolate_gps_velocities(arrays[4], arrays[5], frame_t, settings, device=cuda)
    want = interpolate_gps_velocities(arrays[4], arrays[5], frame_t, settings, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_corpus_in_float64_follows_the_cpu_with_hills(cuda):
    from pilotguru_tpu_torch.calib.corpus import RideArrays, fit_motion_corpus
    from pilotguru_tpu_torch.calib.fit_motion import FitMotionConfig

    import chip_smoke

    rides = [RideArrays(*chip_smoke.make_imu_ride(120.0, climb_m_s=1.5, seed=s)[0])
             for s in (6, 7)]
    card = fit_motion_corpus(rides, FitMotionConfig(optimization_iters=30, device="cuda"))
    cpu = fit_motion_corpus(rides, FitMotionConfig(optimization_iters=30, device="cpu"))
    # chip_smoke.ANNOTATION_BARS: fit_motion's float64 speeds on a ride with
    # hills and sensor noise, card against CPU (1.45e-8 m/s read here).
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.velocity_times_usec, b.velocity_times_usec)
        np.testing.assert_allclose(a.velocities_m_s, b.velocities_m_s, rtol=0,
                                   atol=chip_smoke.ANNOTATION_BARS["float64"]["velocities-imu.json"])


@pytest.mark.cuda
def test_seed_two_tracks_as_recorded(cuda):
    """The first 20 parallax frames at RANSAC seed 2 on the card in float32
    lose track where recorded: nowhere since the card computes its two-view
    initialization and SVDs in float64, where the CPU's float32 run loses
    it at frame 13 with one thread and 12 with eight, a decision on a
    rounding-level tie (PERF.md; ROADMAP Queue 3)."""
    import chip_smoke

    lost = chip_smoke.run_seed_guard(list(chip_smoke.render_ride(frames=20)))
    assert lost == chip_smoke.SEED_GUARD["lost_at"]


def _golden_two_view_inputs():
    """The inputs of the tracker's first two-view initialization on the
    golden mp4's first frames, on the card in float32: (p1, p2, mask) and
    the RANSAC samples its generator draws."""
    import chip_smoke
    from pilotguru_tpu_torch.vo import pipeline, tracking, twoview
    from pilotguru_tpu_torch.vo.camera import read_camera_settings

    seen = []
    solve = tracking.two_view_reconstruction

    def recording(p1, p2, mask, generator=None, **kwargs):
        samples = twoview.draw_samples(mask.to(torch.float32) + 1e-6, 128, 8, generator)
        seen.append((p1, p2, mask, samples))
        return solve(p1, p2, mask, samples=samples, **kwargs)

    tracker = pipeline.tracker_from_settings(read_camera_settings(chip_smoke.GOLDEN_CAMERA),
                                             device="cuda", track_chunk_frames=0)
    tracking.two_view_reconstruction = recording
    try:
        for frame in pipeline.video_frames(chip_smoke.GOLDEN_VIDEO):
            tracker.process_frame(frame.gray, frame.frame_id, frame.time_usec)
            if tracker.state != "NOT_INITIALIZED":
                break
    finally:
        tracking.two_view_reconstruction = solve
    assert seen and seen[0][0].is_cuda and seen[0][0].dtype == torch.float32
    return seen


@pytest.mark.cuda
def test_svd_entry_is_as_exact_as_lapack_on_ransac_batches(cuda):
    """Every SVD of a float32 two-view reconstruction on the card
    (twoview.reconstruct: RANSAC batches of 8-point and 4-point systems,
    the refit, the pose recovery) on the golden mp4's first frames: per
    call site, the port's SVD entry lands no further from float64 than the
    CPU's LAPACK float32 on the same inputs, in the singular values and in
    the last right singular vector (ride_seeds.py --probe-svd's measures).
    The tracker itself runs its two-view in float64 on the card; the
    entry's float32 route serves the Sim(3) fits and relocalization."""
    import ride_seeds
    from pilotguru_tpu_torch.utils import linalg
    from pilotguru_tpu_torch.vo import twoview

    inputs = _golden_two_view_inputs()
    seen = []
    entry = linalg.svd

    def recording(a, full_matrices=True):
        seen.append((ride_seeds._caller(depth=1), a.detach().clone(), full_matrices))
        return entry(a, full_matrices=full_matrices)

    linalg.svd = recording
    try:
        for p1, p2, mask, samples in inputs:
            twoview.reconstruct(p1, p2, mask, samples, None, 128, 2e-5, 0.40)
    finally:
        linalg.svd = entry
    worst = {}
    for site, a, full in seen:
        assert a.is_cuda and a.dtype == torch.float32
        want = torch.linalg.svd(a.cpu().double(), full_matrices=full)
        got = ride_seeds._svd_errors(want, linalg.svd(a, full_matrices=full))
        lapack = ride_seeds._svd_errors(want, torch.linalg.svd(a.cpu(), full_matrices=full))
        row = worst.setdefault(site, [0.0] * 4)
        for i, v in enumerate((got[0], got[2], lapack[0], lapack[2])):
            row[i] = max(row[i], v)
    assert {"_essential_from_eight", "_homography_from_four"} <= set(worst)
    for site, (s_err, v_rad, lapack_s, lapack_v) in worst.items():
        assert s_err <= lapack_s and v_rad <= lapack_v, (site, worst[site])


@pytest.mark.cuda
def test_two_view_on_the_card_follows_the_cpu_in_float64(cuda):
    """The card's float32 two-view reconstruction, which computes in
    float64 and rounds, on the golden mp4's first initialization with the
    same RANSAC samples: the CPU's float64 run's inliers, and its rotation,
    translation and points within 1e-6, relative for the points (a few
    float32 ulps)."""
    from pilotguru_tpu_torch.vo import twoview

    for p1, p2, mask, samples in _golden_two_view_inputs():
        got = twoview.two_view_reconstruction(p1, p2, mask, samples=samples)
        want = twoview.two_view_reconstruction(
            p1.cpu().double(), p2.cpu().double(), mask.cpu(), samples=samples.cpu())
        assert got.rotation.dtype == torch.float32
        assert torch.equal(got.inliers.cpu(), want.inliers)
        for g, w in ((got.rotation, want.rotation), (got.translation, want.translation)):
            np.testing.assert_allclose(g.cpu().double().numpy(), w.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.points3d[want.inliers].cpu().double().numpy(),
                                   want.points3d[want.inliers].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_process_frame_runs_k1_and_k2_once_a_frame(cuda):
    """MonocularTracker(feature_fn=None).process_frame on parallax frames
    at 2000 features / 8 levels: K1 and K2 once a frame, no plain call, and
    the run equal to the bit to a features + process_features run
    (chip_smoke.run_process_frame, the smoke's 9b)."""
    import chip_smoke

    launches = chip_smoke.run_process_frame(list(chip_smoke.render_ride(frames=12)))
    assert launches == {"fast_nms": 12, "gather_patches": 12, "gather_blurred_patches": 0}


@pytest.mark.cuda
def test_sharded_prefetch_equals_one_device_prefetch(cuda):
    """prefetch_features over [cuda:0, cuda:0] on 12 parallax frames at
    2000 features / 8 levels, batch 8 (sub-batches 4/4, then 2/2): every
    feature and device row equal to the bit to the one-device prefetcher's,
    in order, with K1 and K2 once a frame (chip_smoke.run_sharded_prefetch,
    the smoke's phase 15b (b))."""
    import chip_smoke

    row = chip_smoke.run_sharded_prefetch(list(chip_smoke.render_ride(frames=12)),
                                          [torch.device("cuda", 0)] * 2)
    assert row["equal"]
    assert row["launches"] == {"fast_nms": 12, "gather_patches": 12,
                               "gather_blurred_patches": 0}


@pytest.mark.cuda
def test_image_list_cli_without_cv2_on_the_card(cuda, tmp_path):
    """The VO CLI in a child process without cv2, on the first 40 parallax
    frames as a gray PNG list, writes the trajectory that the segment loop
    writes from the same frames in memory, with K1 and K2 once a frame."""
    import json
    import os
    import subprocess
    import sys

    import chip_smoke
    from pilotguru_tpu_torch.video.io import write_image_list
    from pilotguru_tpu_torch.vo import pipeline
    from pilotguru_tpu_torch.vo.camera import write_camera_settings

    frames = list(chip_smoke.render_ride(frames=40))
    times = [int(round(i * 1e6 / 30.0)) for i in range(len(frames))]
    index = write_image_list(str(tmp_path / "frames"), frames, times)
    write_camera_settings(chip_smoke.ride_settings(), str(tmp_path / "camera.yaml"))
    env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cuda", PYTHONPATH=chip_smoke.REPO_DIR)
    run = subprocess.run(
        [sys.executable, "-c", chip_smoke.VO_CLI_CHILD,
         f"--camera_settings={tmp_path / 'camera.yaml'}", f"--in_video={index}",
         f"--out_dir={tmp_path / 'cli'}"], capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    child = json.loads(run.stdout.strip().splitlines()[-1])
    assert child["cv2_unimportable"]
    assert child["launches"] == {"fast_nms": 40, "gather_patches": 40,
                                 "gather_blurred_patches": 0}
    pipeline.track_video_segments(
        (pipeline.VideoFrame(g, i, t) for i, (g, t) in enumerate(zip(frames, times))),
        chip_smoke.ride_settings(), str(tmp_path / "memory"), device="cuda")
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(os.listdir(tmp_path / "memory"))
    for name in os.listdir(tmp_path / "memory"):
        assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "memory" / name).read_bytes()


@pytest.mark.cuda
def test_predict_video_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """predict_video with chip_smoke's PilotNet x3 at 66x200x3 over 40 road
    frames: the card in float32 within 1e-4 of the CPU's float32 on every
    frame (TF32 off)."""
    import chip_smoke
    from pilotguru_tpu_torch.cli import predict_video
    from pilotguru_tpu_torch.formats import json_io

    monkeypatch.setitem(chip_smoke.ROAD, "frames", 40)
    paths = chip_smoke.write_road_ride(str(tmp_path / "road"))
    checkpoints = chip_smoke.write_pilotnet_checkpoints(str(tmp_path))
    settings = str(tmp_path / "settings.json")
    json_io.write_json({**chip_smoke.PILOTNET["settings"], "compute_dtype": "float32"}, settings)
    out = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", platform)
        out[platform] = str(tmp_path / f"{platform}.json")
        assert predict_video.main(chip_smoke.predict_argv(paths, checkpoints, settings,
                                                          out[platform])) == 0
    card_ids, card = chip_smoke._steering(out["cuda"])
    cpu_ids, cpu = chip_smoke._steering(out["cpu"])
    np.testing.assert_array_equal(card_ids, cpu_ids)
    assert len(card) == 40
    np.testing.assert_allclose(card, cpu, rtol=0, atol=chip_smoke.PREDICT_F32_BAR)


@pytest.mark.cuda
def test_folded_train_step_on_the_card_matches_the_cpu(cuda):
    """One folded PilotNet x3 train step (Adam, float32, batch 32, augmentation
    off, net 2 masked off) on the card against the same step on the CPU."""
    from pilotguru_tpu_torch.ml import augmentation, convert, models, training

    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    bias = [{"input_name": "forward_axis", "input_dims": 3}]
    model = models.make_network(options, bias, (66, 200, 3))
    settings = training.TrainSettings(epochs=1, batch_size=32, optimizer="adam",
                                      augment=augmentation.AugmentSettings(target_width=200))
    tx = training.make_optimizer("adam", 1e-3)
    rng = np.random.default_rng(4)
    batch = {"frame_img": torch.as_tensor(rng.integers(0, 256, (32, 66, 200, 3), dtype=np.uint8)),
             "forward_axis": torch.as_tensor(rng.normal(size=(32, 3)).astype(np.float32))}
    labels = torch.as_tensor(rng.normal(0, 0.5, (32, 1)).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.5, 1.5, (3, 32)).astype(np.float32))
    mask = torch.tensor([True, True, False])
    out = {}
    for device in ("cpu", cuda):
        state = training.init_ensemble(model, {}, 3, tx, seed=1, device=device)
        step = training.make_train_step(model, tx, settings)
        state, losses, _ = step(state, {k: v.to(device) for k, v in batch.items()},
                                labels.to(device), weights.to(device), mask.to(device),
                                torch.Generator(device=device).manual_seed(0))
        out[str(device)] = (losses.cpu(), convert.ensemble_to_flax(state.params, state.batch_stats))
    (cpu_losses, (cpu_params, cpu_stats)), (card_losses, (card_params, card_stats)) = out.values()
    torch.testing.assert_close(card_losses, cpu_losses, rtol=1e-4, atol=1e-6)

    def leaves(tree):
        return [v for t in tree.values() for v in (leaves(t) if isinstance(t, dict) else [t])]

    for want, got in zip(leaves(cpu_stats), leaves(card_stats)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])
    def named(tree, prefix=""):
        return [kv for k, t in tree.items()
                for kv in (named(t, f"{prefix}{k}/") if isinstance(t, dict) else [(prefix + k, t)])]

    for (name, want), (_, got) in zip(named(cpu_params), named(card_params)):
        np.testing.assert_array_equal(got[2], want[2])
        if name.endswith("Conv_0/bias") or (name.startswith("FcBlock_")
                                            and name.endswith("Dense_0/bias")):
            # A bias just before batch norm: its gradient is rounding noise,
            # which Adam turns into +-lr on either device.
            assert np.abs(got - want).max() <= 2e-3 * 1.001, name
            continue
        # Adam's first step is about +-lr: 99% within 1% of it; elements
        # whose gradient is within rounding of 0 may take either sign.
        assert np.mean(np.abs(got - want) <= 1e-5) > 0.99, name


# ------------------------------------------------- fused batch norm + ReLU
# The folded train step's train-mode batch norms at the cells' shapes: conv
# outputs channels-last, as cuDNN leaves them on the folded path, and the FC
# blocks' [B, C].
BN_SHAPES = {
    "train_conv1": (1024, 72, 31, 98),
    "train_conv5": (1024, 192, 1, 18),
    "train_fc1": (1024, 300),
    "search_conv1": (1024, 288, 31, 98),
    # The folded Rambo x3's: the comma trunk's 8x8/4 conv, the four-conv
    # trunk's 5x5/2 first conv, its last 3x3/2 conv, and the 50-wide FC
    # blocks (150 channels, not a multiple of 4).
    "rambo_comma_conv1": (1024, 48, 24, 74),
    "rambo_conv_first": (1024, 108, 48, 148),
    "rambo_conv_last": (1024, 192, 4, 17),
    "rambo_fc50": (1024, 150),
}


def _bn_case(device, shape, dtype, channels_last=True, seed=0):
    """(x, g, scale, bias, mean_ra, var_ra) from a seed, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]

    def normal(*size):
        return torch.randn(size, generator=gen, device=device)

    fmt = torch.channels_last if channels_last and len(shape) == 4 else torch.contiguous_format
    x = (normal(*shape) * 1.5 + normal(1, c, *[1] * (len(shape) - 2))).to(dtype)
    g = normal(*shape).to(dtype)
    x, g = x.contiguous(memory_format=fmt), g.contiguous(memory_format=fmt)
    return (x, g, 1.0 + 0.2 * normal(c), 0.3 * normal(c), 0.1 * normal(c),
            1.0 + normal(c).abs())


def _bn_kernel_and_plain(x, g, scale, bias, mean_ra, var_ra):
    """Forward and backward through the kernels and the plain version; the
    plain backward runs from the kernels' statistics, so both apply the
    same ReLU mask."""
    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    y, stats = bk._forward_cuda(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
    dx, grads = bk._backward_cuda(g, x, scale, bias, stats)
    y_plain, stats_plain = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
    dx_plain, grads_plain = bk.bn_relu_backward_plain(g, x, scale, bias, stats)
    torch.cuda.synchronize()
    return (y, stats, dx, grads), (y_plain, stats_plain, dx_plain, grads_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BN_SHAPES))
def test_bn_relu_kernel_matches_plain(cuda, name, dtype):
    """Every float32 operation is the same in both, rounded the same; only
    the float64 sums run in another order, so a statistic, dscale or dbias
    may round one float32 ulp apart (rtol 2.4e-7 is two ulps). y and dx then
    move by a few float32 ulps of their largest term (1e-6 of the largest
    value), or, rounded to bfloat16, by one bfloat16 ulp (2^-7 of it)."""
    (y, stats, dx, grads), (y_p, stats_p, dx_p, grads_p) = _bn_kernel_and_plain(
        *_bn_case(cuda, BN_SHAPES[name], dtype))
    assert y.stride() == y_p.stride() and dx.stride() == dx_p.stride()
    torch.testing.assert_close(stats[[0, 1, 3, 4]], stats_p[[0, 1, 3, 4]], rtol=2.4e-7, atol=0)
    torch.testing.assert_close(stats[2], stats_p[2], rtol=0, atol=0)  # keep
    torch.testing.assert_close(grads, grads_p, rtol=2.4e-7, atol=1e-9 * float(grads_p.abs().max()))
    rel = 1e-6 if dtype == torch.float32 else 2.0**-7
    for got, want in ((y, y_p), (dx, dx_p)):
        torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                                   atol=rel * float(want.float().abs().max()))


@pytest.mark.cuda
def test_bn_relu_takes_a_contiguous_activation_through_a_channels_last_copy(cuda):
    """A contiguous [B, C, H, W] at conv1's shape: the kernels read a
    channels-last copy; the values are the plain version's, within the
    bars of the test above."""
    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    x, g, scale, bias, mean_ra, var_ra = _bn_case(cuda, BN_SHAPES["train_conv1"], torch.float32,
                                                  channels_last=False)
    xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    y, new_mean, new_var = bk.bn_relu_train(xr, sr, br, mean_ra, var_ra, 1e-5, 0.9)
    y.backward(g)
    y_p, stats_p = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
    dx_p, grads_p = bk.bn_relu_backward_plain(g, x, scale, bias, stats_p)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(torch.stack([new_mean, new_var]), stats_p[3:], rtol=2.4e-7, atol=0)
    torch.testing.assert_close(torch.stack([sr.grad, br.grad]), grads_p[:2], rtol=2.4e-7,
                               atol=1e-9 * float(grads_p.abs().max()))
    for got, want in ((y, y_p), (xr.grad, dx_p)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train_conv1", "train_fc1"])
def test_bn_relu_kernel_repeats_to_the_bit(cuda, name):
    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    x, g, scale, bias, mean_ra, var_ra = _bn_case(cuda, BN_SHAPES[name], torch.float32)
    runs = []
    for _ in range(2):
        y, stats = bk._forward_cuda(x, scale, bias, mean_ra, var_ra, 1e-5, 0.9)
        dx, grads = bk._backward_cuda(g, x, scale, bias, stats)
        runs.append((y, stats, dx, grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bn_relu_kernels_run_nine_times_a_folded_train_step(cuda):
    """One folded PilotNet x3 train step (5 conv and 4 FC batch norms): 9
    forward and 9 backward launches, 9 ``folded.bn_fused`` tallies (beside
    the 5 convs' ``folded.conv_bwd_hand``), no plain call."""
    from pilotguru_tpu_torch.ml import augmentation, bn_relu_kernel, models, training
    from pilotguru_tpu_torch.utils import profiling

    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    settings = training.TrainSettings(epochs=1, batch_size=32,
                                      augment=augmentation.AugmentSettings(target_width=200))
    tx = training.make_optimizer("sgd", 1e-3)
    rng = np.random.default_rng(4)
    batch = {"frame_img": torch.as_tensor(rng.integers(0, 256, (32, 66, 200, 3),
                                                       dtype=np.uint8)).to(cuda),
             "forward_axis": torch.as_tensor(rng.normal(size=(32, 3)).astype(np.float32)).to(cuda)}
    labels = torch.zeros((32, 1), device=cuda)
    state = training.init_ensemble(model, {}, 3, tx, seed=1, device=cuda)
    step = training.make_train_step(model, tx, settings)
    counters = (bn_relu_kernel.COUNTER, bn_relu_kernel.BACKWARD_COUNTER)
    before = [(c.launches, c.plain_cuda_calls) for c in counters]
    timer = profiling.StageTimer("step")
    with profiling.recording(timer):
        step(state, batch, labels, torch.ones((3, 32), device=cuda),
             torch.ones(3, dtype=torch.bool, device=cuda), torch.Generator(device=cuda))
    torch.cuda.synchronize()
    assert [(c.launches - n, c.plain_cuda_calls - p)
            for c, (n, p) in zip(counters, before)] == [(9, 0), (9, 0)]
    assert timer.tallies == {"folded.bn_fused": 9, "folded.conv_bwd_hand": 5}


@pytest.mark.cuda
def test_bn_relu_kernels_run_seventeen_times_a_folded_rambo_train_step(cuda):
    """One folded Rambo x3 train step at the 100x300 crop (12 conv and 5 FC
    batch norms): 17 forward and 17 backward launches, 17
    ``folded.bn_fused`` tallies (beside the 12 convs' ``folded.conv_bwd_hand``
    and no per-net forward), no plain call; the step's losses equal the
    per-net path's within float32 rounding."""
    from pilotguru_tpu_torch.ml import augmentation, bn_relu_kernel, models, training
    from pilotguru_tpu_torch.utils import profiling

    options = {"net_name": "rambo", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (100, 300, 3))
    settings = training.TrainSettings(epochs=1, batch_size=32,
                                      augment=augmentation.AugmentSettings(target_width=300))
    tx = training.make_optimizer("sgd", 1e-3)
    rng = np.random.default_rng(4)
    batch = {"frame_img": torch.as_tensor(rng.integers(0, 256, (32, 100, 300, 3),
                                                       dtype=np.uint8)).to(cuda),
             "forward_axis": torch.as_tensor(rng.normal(size=(32, 3)).astype(np.float32)).to(cuda)}
    labels = torch.as_tensor(rng.normal(0, 0.3, (32, 1)).astype(np.float32)).to(cuda)
    state = training.init_ensemble(model, {}, 3, tx, seed=1, device=cuda)
    step = training.make_train_step(model, tx, settings)
    counters = (bn_relu_kernel.COUNTER, bn_relu_kernel.BACKWARD_COUNTER)
    before = [(c.launches, c.plain_cuda_calls) for c in counters]
    timer = profiling.StageTimer("step")
    args = (state, batch, labels, torch.ones((3, 32), device=cuda),
            torch.ones(3, dtype=torch.bool, device=cuda), torch.Generator(device=cuda))
    with profiling.recording(timer):
        _, losses, _ = step(*args)
    torch.cuda.synchronize()
    assert [(c.launches - n, c.plain_cuda_calls - p)
            for c, (n, p) in zip(counters, before)] == [(17, 0), (17, 0)]
    assert timer.tallies == {"folded.bn_fused": 17, "folded.conv_bwd_hand": 12}
    images = batch["frame_img"].float() / 255.0
    out, _ = training.per_net_forward(model, state.params, state.batch_stats,
                                      dict(batch, frame_img=images), True)
    want = training.power_loss(out, labels, 2.0).mean(1)
    torch.testing.assert_close(losses, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_bn_relu_kernel_refuses_other_dtypes(cuda, dtype):
    from pilotguru_tpu_torch.ml import bn_relu_kernel as bk

    x = torch.ones((8, 4), dtype=dtype, device=cuda)
    params = [torch.ones(4, device=cuda) for _ in range(4)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bk.bn_relu_train(x, *params, 1e-5, 0.9)


@pytest.mark.cuda
def test_folded_train_step_repeats_to_the_bit_on_the_card(cuda):
    """Two folded PilotNet x3 SGD steps at batch 256 from equal states on the
    same batch, under the training loop's deterministic cuDNN: the same
    losses, parameters and batch statistics to the bit (the fused batch
    norm sums in a fixed order, with no float atomics)."""
    from pilotguru_tpu_torch.ml import augmentation, models, training

    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 2,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    settings = training.TrainSettings(epochs=1, batch_size=256,
                                      augment=augmentation.AugmentSettings(target_width=200))
    tx = training.make_optimizer("sgd", 1e-2)
    rng = np.random.default_rng(8)
    batch = {"frame_img": torch.as_tensor(rng.integers(0, 256, (256, 66, 200, 3),
                                                       dtype=np.uint8)).to(cuda),
             "forward_axis": torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32)).to(cuda)}
    labels = torch.as_tensor(rng.normal(0, 0.3, (256, 2)).astype(np.float32)).to(cuda)
    step = training.make_train_step(model, tx, settings)

    def leaves(tree):
        return [v for t in tree.values() for v in (leaves(t) if isinstance(t, dict) else [t])]

    runs = []
    with training._deterministic_cudnn():
        for _ in range(2):
            state = training.init_ensemble(model, {}, 3, tx, seed=1, device=cuda)
            state, losses, per_example = step(
                state, batch, labels, torch.ones((3, 256), device=cuda),
                torch.ones(3, dtype=torch.bool, device=cuda),
                torch.Generator(device=cuda).manual_seed(0))
            runs.append([losses, per_example, *leaves(state.params), *leaves(state.batch_stats)])
    torch.cuda.synchronize()
    assert len(runs[0]) == len(runs[1]) > 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------- the folded convs' backward
# The cells' largest layers, and one of each other kernel instance: (input
# channels a net, output channels a net, kernel, stride, input height,
# width, nets, shared input) at batch 1,024.
CONV_SHAPES = {
    "train_conv2": (24, 36, 5, 2, 31, 98, 3, False),
    "search_conv2": (24, 36, 5, 2, 31, 98, 12, False),
    "rambo_four2": (36, 48, 5, 2, 48, 148, 3, False),
    "rambo_four1": (3, 36, 5, 2, 100, 300, 3, True),
    "rambo_comma1": (3, 16, 8, 4, 100, 300, 3, True),
    "train_conv4": (48, 64, 3, 1, 5, 22, 3, False),
    "rambo_four3": (48, 64, 3, 2, 22, 72, 3, False),
}


def _conv_case(device, name, batch=1024, seed=0):
    """(x, kernel, dy, stride, groups): x and dy channels-last."""
    cin, cout, k, stride, h, w, nets, shared = CONV_SHAPES[name]
    groups = 1 if shared else nets
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, cin * groups, h, w), generator=gen, device=device)
    kernel = torch.randn((nets, k, k, cin, cout), generator=gen, device=device) / k / cin**0.5
    dy = torch.randn((batch, nets * cout, (h - k) // stride + 1, (w - k) // stride + 1),
                     generator=gen, device=device)
    return (x.contiguous(memory_format=torch.channels_last), kernel,
            dy.contiguous(memory_format=torch.channels_last), stride, groups)


def _conv_grads(x, kernel, dy, stride, groups, plain):
    """(dx or None, dW, db) through the kernels or their plain version."""
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
        dw, db = ck.conv_wgrad_plain(x, dy, groups, k, stride, cout, splits)
    else:
        dw, db = ck._wgrad_cuda(x, dy, tuple(kernel.shape), stride, groups)
    torch.cuda.synchronize()
    return dx, dw, db


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv_bwd_kernels_match_plain(cuda, name):
    """dx, dW and db against the plain version (cuBLAS products in full
    float32, summed tap by tap and partition by partition as the kernels
    sum): each within float32 rounding of its norm. The kernels add up to
    1,350 products a dx element and 400,000 a partition of dW in one FMA
    chain; against float64 they read at most 6e-6 of the norm at these
    layers (cuDNN's float32 backward about 1e-6), so the bar is 2e-5."""
    got = _conv_grads(*_conv_case(cuda, name), plain=False)
    want = _conv_grads(*_conv_case(cuda, name), plain=True)
    for label, a, b in zip(("dx", "dW", "db"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.stride() == b.stride(), label
        assert float((a - b).norm() / b.norm()) <= 2e-5, label


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rambo_four2", "search_conv2", "rambo_comma1"])
def test_conv_bwd_kernels_repeat_to_the_bit(cuda, name):
    case = _conv_case(cuda, name)
    first, second = (_conv_grads(*case, plain=False) for _ in range(2))
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_conv_bwd_kernels_refuse_other_dtypes(cuda, dtype):
    from pilotguru_tpu_torch.ml import conv_kernel as ck

    x, kernel, dy, stride, groups = _conv_case(cuda, "train_conv4", batch=8)
    with pytest.raises(ValueError, match="float32"):
        ck._wgrad_cuda(x.to(dtype), dy.to(dtype), tuple(kernel.shape), stride, groups)


def _folded_step(cuda, net, hand, monkeypatch, batch=256):
    """One folded x3 float32 SGD step on the card, its convs' backward
    through the kernels (``hand``) or cuDNN's deterministic algorithms:
    (losses, each leaf's gradient, the tallies, the conv launches)."""
    from pilotguru_tpu_torch.ml import augmentation, conv_kernel, models, training
    from pilotguru_tpu_torch.utils import profiling

    if not hand:
        monkeypatch.setattr(conv_kernel, "hand_backward", lambda x, train: False)
    height, width = (66, 200) if net == "nvidia" else (100, 300)
    options = {"net_name": net, "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (height, width, 3))
    tx = training.make_optimizer("sgd", 1e-3)
    state = training.init_ensemble(model, {}, 3, tx, seed=1, device=cuda)
    settings = training.TrainSettings(epochs=1, batch_size=batch,
                                      augment=augmentation.AugmentSettings(target_width=width))
    rng = np.random.default_rng(4)
    batch_in = {"frame_img": torch.as_tensor(rng.integers(0, 256, (batch, height, width, 3),
                                                          dtype=np.uint8)).to(cuda),
                "forward_axis": torch.as_tensor(rng.normal(size=(batch, 3)).astype(np.float32)
                                                ).to(cuda)}
    labels = torch.as_tensor(rng.normal(0, 0.3, (batch, 1)).astype(np.float32)).to(cuda)
    counters = (conv_kernel.COUNTER, conv_kernel.BACKWARD_COUNTER)
    before = [(c.launches, c.plain_cuda_calls) for c in counters]
    timer = profiling.StageTimer("step")
    with profiling.recording(timer), training._deterministic_cudnn():
        new, losses, _ = training.make_train_step(model, tx, settings)(
            state, batch_in, labels, torch.ones((3, batch), device=cuda),
            torch.ones(3, dtype=torch.bool, device=cuda), torch.Generator(device=cuda))
    torch.cuda.synchronize()
    launches = [(c.launches - n, c.plain_cuda_calls - p) for c, (n, p) in zip(counters, before)]

    def leaves(tree, prefix=""):
        return {k2: v2 for k, t in tree.items()
                for k2, v2 in (leaves(t, f"{prefix}{k}/") if isinstance(t, dict)
                               else {prefix + k: t}).items()}

    old, now = leaves(state.params), leaves(new.params)
    return losses, {k: (old[k] - now[k]) / 1e-3 for k in old}, dict(timer.tallies), launches


@pytest.mark.cuda
@pytest.mark.parametrize("net,dgrads,convs", [("nvidia", 4, 5), ("rambo", 9, 12)])
def test_folded_step_through_the_conv_kernels_follows_cudnn(cuda, net, dgrads, convs,
                                                            monkeypatch):
    """A folded x3 float32 train step launches dgrad once a grouped conv
    and wgrad once a conv (4 and 5 for PilotNet, 9 and 12 for Rambo; the
    trunks' first convs take no dgrad), tallies ``folded.conv_bwd_hand``
    once a conv, and its gradients follow the cuDNN path's within the
    cells' first-gradient limit (0.008 of the leaf's norm or the median
    leaf's, per net)."""
    losses, grads, tallies, launches = _folded_step(cuda, net, True, monkeypatch)
    assert launches == [(dgrads, 0), (convs, 0)]
    assert tallies.get("folded.conv_bwd_hand") == convs
    want_losses, want, want_tallies, _ = _folded_step(cuda, net, False, monkeypatch)
    assert "folded.conv_bwd_hand" not in want_tallies
    torch.testing.assert_close(losses, want_losses, rtol=0, atol=0)
    norms = {(k, n): float(g[n].double().norm()) for k, g in want.items()
             for n in range(g.shape[0])}
    median = float(np.median(list(norms.values())))
    for (k, n), norm in norms.items():
        gap = abs(float(grads[k][n].double().norm()) - norm) / max(norm, median)
        assert gap <= 0.008, (k, n, gap)
