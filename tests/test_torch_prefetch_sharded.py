"""The port's feature prefetcher spread over several devices
(vo/pipeline.py: prefetch_features with a device list) on the CPU, on the
first frames of the golden video at the golden camera's ORB settings.

- Over ``[cpu] * 2`` and ``[cpu] * 3`` at batch 8 on 11 frames (a full
  batch, then a short one of 3: sub-batches 4/4 and 2/1, 3/3/2 and
  1/1/1), every feature and device row equals the one-device
  prefetcher's to the bit, frames in their input order: each sub-batch is
  extracted alone and no operation of the extractor changes its bits with
  the batch's length.
- Each frame launches the FAST kernel once and one patch gather once,
  counted through tests/test_torch_prefetch.py's stubs of the kernel
  wrappers.
- Against the JAX prefetcher over the 8 virtual devices of
  tests/conftest.py (its shard_map branch, which pads the batch up to a
  multiple of 8), with tests/test_torch_prefetch.py's comparison. The
  JAX package computes the FAST response there by its jnp route
  (PGTPU_FAST_IMPL=jnp): its Pallas kernel does not trace inside this JAX
  version's shard_map, which asks the kernel's output shapes for a
  ``vma``.
- The segment loop hands the prefetcher the tracker's device alone on the
  CPU, and on a card every visible card, the tracker's first.
"""

import jax
import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.vo import features, pipeline
from pilotguru_tpu_torch.vo.fast_kernel import COUNTER
from pilotguru_tpu_torch.vo.patch_kernel import BLUR_COUNTER
from pilotguru_tpu_torch.vo.patch_kernel import COUNTER as GATHER_COUNTER
from test_torch_prefetch import (
    INPUTS,
    _camera_and_config,
    _fresh,
    assert_matches_reference,
    reference_prefetched,
)

torch.set_num_threads(1)

FRAMES = 11
BATCH = 8


@pytest.fixture(scope="module")
def golden_frames():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        frames = pipeline.video_frames(f"{INPUTS}/video.mp4")
        return [next(frames) for _ in range(FRAMES)]


def _prefetch(frames, devices, config=None, batch=BATCH):
    camera, base = _camera_and_config()
    return list(pipeline.prefetch_features(iter(_fresh(frames)), camera, config or base, batch,
                                           devices))


@pytest.fixture(scope="module")
def one_device(golden_frames):
    return _prefetch(golden_frames, "cpu")


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_prefetch_equals_one_device_to_the_bit(golden_frames, one_device, k):
    got = _prefetch(golden_frames, ["cpu"] * k)
    assert [f.frame_id for f in got] == [f.frame_id for f in one_device] == list(range(FRAMES))
    for g, w in zip(got, one_device):
        for a, b in zip(g.features, w.features):
            a, b = (x.numpy() if isinstance(x, torch.Tensor) else x for x in (a, b))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g.dev_features, w.dev_features):
            assert a.device == b.device == torch.device("cpu")
            assert torch.equal(a, b)
        assert g.features[2].sum() > 300


@pytest.mark.parametrize("patch_impl, gathers", [
    ("blur_then_gather", {"fast_nms": FRAMES, "gather_patches": FRAMES,
                          "gather_blurred_patches": 0}),
    ("fused", {"fast_nms": FRAMES, "gather_patches": 0, "gather_blurred_patches": FRAMES}),
])
def test_each_frame_launches_each_kernel_once(golden_frames, monkeypatch, patch_impl, gathers):
    """The stubs count a launch a call, as the CUDA branch does, then run
    the plain versions: one call a frame over its levels, in every
    sub-batch, the short ones included."""
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
    got = _prefetch(golden_frames, ["cpu"] * 3, config)
    assert len(got) == FRAMES
    assert {c.name: c.launches for c in counters} == gathers
    assert all(c.plain_cuda_calls == 0 for c in counters)
    for c in counters:
        c.reset()


def test_sharded_prefetch_against_the_jax_prefetcher_over_8_devices(golden_frames,
                                                                     monkeypatch):
    frames = golden_frames[:5]
    assert len(jax.devices()) == 8
    want, probe = reference_prefetched(frames, monkeypatch, None, "jnp")
    assert_matches_reference(_prefetch(frames, ["cpu"] * 3, batch=2), want, frames, probe)


def test_segment_loop_prefetches_over_every_card(monkeypatch):
    assert pipeline._prefetch_devices("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert pipeline._prefetch_devices("cuda:0") == cards
    assert pipeline._prefetch_devices(torch.device("cuda", 2)) == [cards[2]] + cards[:2]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert pipeline._prefetch_devices("cuda") == [cards[1], cards[0], cards[2]]


def test_prefetch_device_arguments():
    assert pipeline._device_list(None, "cpu") == [torch.device("cpu")]
    assert pipeline._device_list(["cpu", torch.device("cpu")], None) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not both"):
        pipeline._device_list(["cpu"], "cpu")
    with pytest.raises(ValueError, match="empty"):
        pipeline._device_list([], None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline._device_list(None, None)
