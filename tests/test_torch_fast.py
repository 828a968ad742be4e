"""K1 (FAST-9/16 response + 3x3 NMS): the port's plain PyTorch version
against the JAX package's plain jnp path (fast_scores + nms3x3) and its
Pallas kernel in interpret mode (the CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.vo.fast_pallas import fast_nms_pallas
from pilotguru_tpu.vo.features import FAST_CIRCLE as JAX_FAST_CIRCLE
from pilotguru_tpu.vo.features import fast_scores, nms3x3
from pilotguru_tpu_torch.vo import fast_kernel
from pilotguru_tpu_torch.vo.fast_kernel import fast_nms, fast_nms_levels, fast_nms_plain

torch.set_num_threads(1)
THR = 20.0 / 255.0


def _image(shape, seed):
    if shape == "square":
        img = np.full((64, 64), 0.2, np.float32)
        img[20:40, 20:40] = 0.9  # a bright square: corners at its vertices
        return img
    return np.random.default_rng(seed).uniform(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 96), (120, 160), (130, 250), "square"])
def test_plain_matches_jax(shape):
    img = _image(shape, 0)
    raw, nms = fast_nms(torch.from_numpy(img), THR)
    raw, nms = raw.numpy(), nms.numpy()

    want_raw = np.asarray(fast_scores(jnp.asarray(img), THR))
    want_nms = np.asarray(nms3x3(jnp.asarray(want_raw)))
    # The jnp path sums the 16 taps as a stacked reduction (another order):
    # atol 1e-5 on the response, and the NMS support must be identical.
    np.testing.assert_allclose(raw, want_raw, atol=1e-5)
    np.testing.assert_allclose(nms, want_nms, atol=1e-5)
    assert ((nms > 0) == (want_nms > 0)).all()

    # The Pallas kernel accumulates the taps in FAST_CIRCLE order, like the
    # port: measured bit-identical (max-abs 0), held exactly.
    p_raw, p_nms = fast_nms_pallas(jnp.asarray(img), threshold=THR, interpret=True)
    np.testing.assert_array_equal(raw, np.asarray(p_raw))
    np.testing.assert_array_equal(nms, np.asarray(p_nms))
    assert raw.sum() > 0
    assert raw[:3].sum() == 0 and raw[:, :3].sum() == 0
    assert raw[-3:].sum() == 0 and raw[:, -3:].sum() == 0


def test_circle_table_matches_reference():
    assert fast_kernel.FAST_CIRCLE.tobytes() == JAX_FAST_CIRCLE.tobytes()
    src = open(fast_kernel.__file__.replace("vo/fast_kernel.py", "csrc/fast_nms.cu")).read()
    dy = ", ".join(str(v) for v in fast_kernel.FAST_CIRCLE[:, 0])
    dx = ", ".join(str(v) for v in fast_kernel.FAST_CIRCLE[:, 1])
    flat = " ".join(src.split())
    assert f"kCircleDy[16] = {{{dy}}}" in flat.replace(",\n", ", ")
    assert f"kCircleDx[16] = {{{dx}}}" in flat.replace(",\n", ", ")


def test_cpu_dispatch_runs_plain_version_without_launching():
    fast_kernel.COUNTER.reset()
    img = torch.from_numpy(_image((40, 50), 1))
    raw, nms = fast_nms(img)
    want_raw, want_nms = fast_nms_plain(img)
    assert torch.equal(raw, want_raw) and torch.equal(nms, want_nms)
    assert fast_kernel.COUNTER.launches == 0
    assert fast_kernel.COUNTER.plain_cuda_calls == 0


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        fast_nms(torch.zeros((8, 8), device="meta"))


LEVEL_SHAPES = [(96, 128), (80, 107), (67, 89), (56, 74)]


def test_levels_equal_per_level_plain_and_pallas():
    """fast_nms_levels on a seeded pyramid: exactly the per-level plain
    calls, and exactly the Pallas kernel in interpret mode (K1's bar)."""
    rng = np.random.default_rng(5)
    images = [rng.uniform(0, 1, size=shape).astype(np.float32) for shape in LEVEL_SHAPES]
    fast_kernel.COUNTER.reset()
    got = fast_nms_levels([torch.from_numpy(i) for i in images], THR)
    assert len(got) == len(images)
    assert fast_kernel.COUNTER.launches == 0 and fast_kernel.COUNTER.plain_cuda_calls == 0
    for (raw, nms), img in zip(got, images):
        want_raw, want_nms = fast_nms_plain(torch.from_numpy(img), THR)
        assert torch.equal(raw, want_raw) and torch.equal(nms, want_nms)
        p_raw, p_nms = fast_nms_pallas(jnp.asarray(img), threshold=THR, interpret=True)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(p_raw))
        np.testing.assert_array_equal(nms.numpy(), np.asarray(p_nms))
        assert raw.shape == img.shape and float(raw.sum()) > 0


@pytest.mark.parametrize("case", ["empty", "too_many", "dtype", "shape", "device_mix",
                                  "not_contiguous", "device"])
def test_levels_wrapper_rejects(case):
    good = torch.zeros((16, 16))
    bad = {
        "empty": ([], "1 to 8 images"),
        "too_many": ([good] * 9, "1 to 8 images"),
        "dtype": ([good, good.double()], "2-D float32"),
        "shape": ([good, torch.zeros((2, 16, 16))], "2-D float32"),
        "device_mix": ([good, torch.zeros((16, 16), device="meta")], "different devices"),
        "not_contiguous": ([good, torch.zeros((16, 32))[:, ::2]], "contiguous"),
        "device": ([torch.zeros((16, 16), device="meta")], "unsupported device"),
    }
    images, message = bad[case]
    with pytest.raises(ValueError, match=message):
        fast_nms_levels(images)

