"""The port's batched feature prefetcher (vo/pipeline.py: prefetch_features
on its worker thread, background_frames) on the CPU, on the first frames
of the golden video at the golden camera's ORB settings (600 features, 3
levels).

- Against the port's per-frame extraction (MonocularTracker.features):
  5 frames at batch 2, the last batch one frame, not padded. Valid masks,
  levels and descriptors equal; keypoints within 1e-6, angles within 1e-5
  (measured: all equal).
- Against the JAX package's prefetch_features on the same frames, its
  FAST kernel on the TPU path (Pallas, interpret mode), which the port's
  extractor follows (tests/test_torch_features.py): valid masks and levels
  equal; keypoints within 1e-6, descriptors equal but for angles within
  1e-4 rad of a steering-bin boundary and angles within 1e-4, except in
  the few level-0 slots (at most 2% of the valid ones; measured 1 to 5 of
  about 370 a frame) where
  the reference's batched program picks another keypoint than its own
  one-frame extractor: there the port holds the one-frame extractor's.
- The tracker's patch path reaches the extractor, and each frame runs the
  FAST kernel once and one patch gather (K2, or K3 when fused) once,
  counted through stubs of the kernel wrappers that count as the CUDA
  launches do.
- The segment loop prefetches whenever its feature batch size is above 0,
  with the first tracker's camera and configuration, a caller's own
  make_tracker included.
- An exception in the frame iterator is raised in the consumer; the launch
  counters lose no count under many threads.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.video import native as jax_native_video
from pilotguru_tpu.vo import features as jfeatures
from pilotguru_tpu.vo import pipeline as jpipeline
from pilotguru_tpu.vo.camera import read_camera_settings as jax_read_camera_settings
from pilotguru_tpu_torch import cuda_lib
from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.vo import features, pipeline, tracking
from pilotguru_tpu_torch.vo.camera import read_camera_settings
from pilotguru_tpu_torch.vo.fast_kernel import COUNTER
from pilotguru_tpu_torch.vo.patch_kernel import BLUR_COUNTER
from pilotguru_tpu_torch.vo.patch_kernel import COUNTER as GATHER_COUNTER

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
FRAMES = 5
BATCH = 2


@pytest.fixture(scope="module")
def golden_start():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        frames = pipeline.video_frames(f"{INPUTS}/video.mp4")
        return [next(frames) for _ in range(FRAMES)]


def _fresh(frames):
    return [pipeline.VideoFrame(f.gray, f.frame_id, f.time_usec) for f in frames]


def _camera_and_config(**config):
    camera, base = pipeline.camera_and_config(read_camera_settings(f"{INPUTS}/camera.yaml"))
    return camera, dataclasses.replace(base, **config)


def _prefetched(frames, config=None):
    camera, base = _camera_and_config()
    return list(pipeline.prefetch_features(iter(_fresh(frames)), camera, config or base,
                                           BATCH, device="cpu"))


def test_prefetch_equals_per_frame_extraction(golden_start):
    camera, config = _camera_and_config()
    got = _prefetched(golden_start)
    assert [f.frame_id for f in got] == list(range(FRAMES))
    tracker = tracking.MonocularTracker(camera, config, device="cpu")
    for frame in got:
        kp, desc, valid, level, angle = frame.features
        want_kp, want_desc, want_valid, want_level, want_angle = tracker.features(frame.gray)
        assert isinstance(desc, torch.Tensor)
        np.testing.assert_array_equal(valid, want_valid)
        np.testing.assert_array_equal(level, want_level)
        np.testing.assert_array_equal(desc.numpy(), want_desc)
        np.testing.assert_allclose(kp, want_kp, atol=1e-6, rtol=0)
        np.testing.assert_allclose(angle, want_angle, atol=1e-5, rtol=0)
        assert valid.sum() > 300
        # The device rows are the host arrays' source.
        dev_kp, dev_desc, dev_valid, dev_level = frame.dev_features
        np.testing.assert_array_equal(dev_kp.numpy(), kp)
        assert dev_desc is desc
        np.testing.assert_array_equal(dev_valid.numpy(), valid)
        np.testing.assert_array_equal(dev_level.numpy(), level)


def reference_prefetched(frames, monkeypatch, devices, fast_impl="pallas"):
    """(the JAX prefetcher's frames over ``devices``, its probe tracker),
    its FAST kernel on the TPU path (Pallas, interpret mode) unless
    ``fast_impl`` names another."""
    monkeypatch.setattr(jax_native_video, "available", lambda: False)
    monkeypatch.setenv("PGTPU_FAST_IMPL", fast_impl)
    probe = jpipeline.tracker_from_settings(jax_read_camera_settings(f"{INPUTS}/camera.yaml"))
    # The reference's batch extractor is cached per process and reads the
    # switch while it traces: trace it afresh, and leave no such trace.
    jpipeline._extract_pack_jit.cache_clear()
    try:
        want = list(jpipeline.prefetch_features(
            iter([jpipeline.VideoFrame(f.gray, f.frame_id, f.time_usec) for f in frames]),
            probe.camera, probe.config, BATCH, devices=devices))
    finally:
        jpipeline._extract_pack_jit.cache_clear()
    return want, probe


def test_prefetch_matches_reference_prefetch(golden_start, monkeypatch):
    want, probe = reference_prefetched(golden_start, monkeypatch, [jax.devices()[0]])
    assert_matches_reference(_prefetched(golden_start), want, golden_start, probe)


def assert_matches_reference(got, want, frames, probe):
    """The port's prefetched frames ``got`` against the JAX prefetcher's
    ``want`` on the same ``frames``, with the bars of the module docstring."""
    config = probe.config
    one_frame = jax.jit(
        lambda image: jfeatures.extract_orb_features.__wrapped__(
            image, num_levels=config.num_levels, scale=config.scale,
            threshold=config.fast_threshold, total_budget=config.total_budget))
    assert [f.frame_id for f in want] == [f.frame_id for f in got] == \
        [f.frame_id for f in frames]
    step = 2 * np.pi / features.BRIEF_ANGLE_BINS
    for g, w, frame in zip(got, want, frames):
        kp, desc, valid, level, angle = g.features
        w_kp, w_desc, w_valid, w_level, w_angle = (np.asarray(a) for a in w.features)
        np.testing.assert_array_equal(valid, w_valid)
        np.testing.assert_array_equal(level, w_level)
        # The reference's batched program (lax.map) picks another level-0
        # keypoint than its own one-frame extractor in a few slots (measured
        # 1 to 5 of about 370 valid ones a frame); there the port holds the one-frame
        # extractor's keypoint, which it follows everywhere else
        # (tests/test_torch_features.py).
        single = jax.tree.map(np.asarray, one_frame(jnp.asarray(frame.gray / np.float32(255.0))))
        s_kp = probe.camera.normalize(single.xy)
        apart = valid & (np.abs(s_kp - w_kp).max(axis=1) > 1e-6)
        assert apart.sum() <= 0.02 * valid.sum() and (w_level[apart] == 0).all()
        np.testing.assert_allclose(kp[apart], s_kp[apart], atol=1e-6, rtol=0)
        same_slot = valid & ~apart
        np.testing.assert_allclose(kp[same_slot], w_kp[same_slot], atol=1e-6, rtol=0)
        np.testing.assert_allclose(angle[same_slot], w_angle[same_slot], atol=1e-4, rtol=0)
        same = (desc.numpy() == w_desc).all(axis=1)
        edge = np.abs((w_angle / step) % 1.0 - 0.5) * step < 1e-4
        assert (same | edge | ~same_slot).all()


@pytest.mark.parametrize("patch_impl, gathers", [
    ("blur_then_gather", {"fast_nms": FRAMES, "gather_patches": FRAMES,
                          "gather_blurred_patches": 0}),
    ("fused", {"fast_nms": FRAMES, "gather_patches": 0,
               "gather_blurred_patches": FRAMES}),
])
def test_each_frame_launches_each_kernel_once(golden_start, monkeypatch, patch_impl,
                                              gathers):
    """Stubs of the all-level kernel wrappers count a launch a call, as the
    CUDA branch does, then run the plain versions: no padded tail frame,
    and the tracker's patch path picks the gather."""
    for name, counter in (("fast_nms_levels", COUNTER),
                          ("gather_patches_levels", GATHER_COUNTER),
                          ("gather_blurred_patches_levels", BLUR_COUNTER)):
        real = getattr(features, name)

        def counted(*args, _real=real, _counter=counter, **kwargs):
            _counter.count_launch()
            return _real(*args, **kwargs)

        monkeypatch.setattr(features, name, counted)
    counters = (COUNTER, GATHER_COUNTER, BLUR_COUNTER)
    for c in counters:
        c.reset()
    _, config = _camera_and_config(patch_impl=patch_impl)
    got = _prefetched(golden_start, config)
    assert len(got) == FRAMES
    assert {c.name: c.launches for c in counters} == gathers
    assert all(c.plain_cuda_calls == 0 for c in counters)
    for c in counters:
        c.reset()


def test_feature_batch_size_alone_decides_prefetching(golden_start, monkeypatch, tmp_path):
    """With a caller's make_tracker the segment loop still prefetches, with
    that tracker's camera and configuration (here the fused patch path) on
    its device, and makes no tracker for the prefetcher; a batch size of 0
    extracts inline."""
    seen = []
    real = pipeline.prefetch_features

    def recording(frames, camera, config, batch_size=8, device="cuda"):
        seen.append((camera, config, batch_size, device))
        return real(frames, camera, config, batch_size, device)

    monkeypatch.setattr(pipeline, "prefetch_features", recording)
    settings = read_camera_settings(f"{INPUTS}/camera.yaml")
    trackers = []

    def make_tracker():
        trackers.append(pipeline.tracker_from_settings(
            settings, device="cpu", patch_impl="fused", track_chunk_frames=0))
        return trackers[-1]

    for batch in (BATCH, 0):
        trackers.clear()
        _, consumed = pipeline.track_video_segments(
            iter(_fresh(golden_start)), settings, str(tmp_path / str(batch)),
            make_tracker=make_tracker, feature_batch_size=batch, device="cpu")
        assert consumed == FRAMES and len(trackers) == 1
    assert len(seen) == 1
    camera, config, batch, device = seen[0]
    assert batch == BATCH and device == torch.device("cpu")
    assert config.patch_impl == "fused" and config.track_chunk_frames == 0
    assert camera == trackers[0].camera


def test_worker_exception_reaches_the_consumer(golden_start):
    class Broken(Exception):
        pass

    def frames():
        yield from _fresh(golden_start[:3])
        raise Broken("decoder failed at frame 3")

    camera, config = _camera_and_config()
    with pytest.raises(Broken, match="frame 3"):
        list(pipeline.prefetch_features(pipeline.background_frames(frames()), camera,
                                        config, BATCH, device="cpu"))
    with pytest.raises(Broken):
        list(pipeline.background_frames(frames()))
    # Frames pass the decode thread in order.
    assert [f.frame_id for f in pipeline.background_frames(iter(_fresh(golden_start)))] == \
        list(range(FRAMES))


def test_launch_counter_loses_no_count_under_threads():
    counter = cuda_lib.KernelCounter("stress")
    threads, each = 16, 5000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [counter.count_launch() for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counter.launches == threads * each
