"""K3 (fused Gaussian blur + patch gather): the port's plain PyTorch version
against the JAX package's Pallas kernel gather_blurred_patches_pallas in
interpret mode, on interior, border and corner keypoints (the CUDA kernel
is held against the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py).

Tolerance: atol 1e-6. Measured max-abs 1.19e-7 (160x200) and 1.79e-7
(64x96): one or two float32 ulps in about half the elements, because XLA's
CPU code for the interpreted Pallas body rounds the tap sums differently
(the port sums each tap as a multiply, then an add)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.vo.patch_pallas import gather_blurred_patches_pallas
from pilotguru_tpu_torch.vo import patch_kernel
from pilotguru_tpu_torch.vo.features import gaussian_blur
from pilotguru_tpu_torch.vo.patch_kernel import (
    gather_blurred_patches,
    gather_blurred_patches_levels,
    gather_blurred_patches_plain,
    gather_patches_plain,
)

torch.set_num_threads(1)


def _keypoints(rng, h, w, k):
    """Random interior keypoints, keypoints within 27 px (blur radius 8 +
    patch radius 19) of each border, and the four corners."""
    interior = np.stack([rng.integers(27, h - 27, k), rng.integers(27, w - 27, k)], 1)
    near = [
        np.stack([rng.integers(0, 27, 4), rng.integers(0, w, 4)], 1),
        np.stack([rng.integers(h - 27, h, 4), rng.integers(0, w, 4)], 1),
        np.stack([rng.integers(0, h, 4), rng.integers(0, 27, 4)], 1),
        np.stack([rng.integers(0, h, 4), rng.integers(w - 27, w, 4)], 1),
    ]
    corners = np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]])
    return np.concatenate([interior, *near, corners]).astype(np.int32)


@pytest.mark.parametrize("shape", [(160, 200), (64, 96)])
def test_matches_pallas_interpret(shape):
    rng = np.random.default_rng(11)
    h, w = shape
    img = rng.uniform(0, 1, size=shape).astype(np.float32)
    yx = _keypoints(rng, h, w, 21)
    got = gather_blurred_patches(torch.from_numpy(img), torch.from_numpy(yx)).numpy()
    want = np.asarray(gather_blurred_patches_pallas(jnp.asarray(img), jnp.asarray(yx), 39,
                                                    interpret=True))
    assert got.shape == want.shape == (yx.shape[0], 39, 39)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0


def test_interior_equals_blur_then_gather():
    """Away from the border (27 px) K3 is blur-then-gather: the same taps in
    the same order (measured max-abs 0)."""
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.uniform(0, 1, size=(120, 150)).astype(np.float32))
    yx = torch.from_numpy(np.stack([rng.integers(27, 93, 30), rng.integers(27, 123, 30)],
                                   1).astype(np.int32))
    fused = gather_blurred_patches_plain(img, yx)
    separate = gather_patches_plain(gaussian_blur(img), yx)
    torch.testing.assert_close(fused, separate, atol=1e-6, rtol=0)


def test_cpu_dispatch_runs_plain_version_without_launching():
    patch_kernel.BLUR_COUNTER.reset()
    rng = np.random.default_rng(13)
    img = torch.from_numpy(rng.uniform(0, 1, size=(40, 60)).astype(np.float32))
    yx = torch.tensor([[3, 4], [39, 59]], dtype=torch.int32)
    assert torch.equal(gather_blurred_patches(img, yx), gather_blurred_patches_plain(img, yx))
    assert patch_kernel.BLUR_COUNTER.launches == 0
    assert patch_kernel.BLUR_COUNTER.plain_cuda_calls == 0


LEVEL_SHAPES = [(96, 128), (80, 107), (67, 89), (56, 74)]


def test_levels_equal_per_level_plain_and_pallas():
    """gather_blurred_patches_levels on a seeded pyramid (interior, border
    and corner keypoints, another count at each level): exactly the
    per-level plain calls, and the Pallas kernel in interpret mode within
    K3's bar (1.8e-7 measured, atol 1e-6 held, module docstring)."""
    rng = np.random.default_rng(14)
    images = [rng.uniform(0, 1, size=shape).astype(np.float32) for shape in LEVEL_SHAPES]
    yx = [_keypoints(rng, h, w, 12 - 3 * level) for level, (h, w) in enumerate(LEVEL_SHAPES)]
    patch_kernel.BLUR_COUNTER.reset()
    got = gather_blurred_patches_levels([torch.from_numpy(i) for i in images],
                                        [torch.from_numpy(k) for k in yx])
    assert patch_kernel.BLUR_COUNTER.launches == 0
    assert patch_kernel.BLUR_COUNTER.plain_cuda_calls == 0
    assert len(got) == len(images)
    for patches, img, level_yx in zip(got, images, yx):
        want = gather_blurred_patches_plain(torch.from_numpy(img), torch.from_numpy(level_yx))
        assert patches.shape == (level_yx.shape[0], 39, 39)
        assert torch.equal(patches, want)
        pallas = np.asarray(gather_blurred_patches_pallas(
            jnp.asarray(img), jnp.asarray(level_yx), 39, interpret=True))
        np.testing.assert_allclose(patches.numpy(), pallas, atol=1e-6, rtol=0)


def test_levels_accepts_a_level_without_keypoints():
    rng = np.random.default_rng(15)
    images = [torch.from_numpy(rng.uniform(0, 1, size=s).astype(np.float32))
              for s in LEVEL_SHAPES[:2]]
    yx = [torch.tensor([[5, 6], [90, 120]], dtype=torch.int32),
          torch.zeros((0, 2), dtype=torch.int32)]
    got = gather_blurred_patches_levels(images, yx)
    assert got[0].shape == (2, 39, 39) and got[1].shape == (0, 39, 39)


@pytest.mark.parametrize("case", ["empty", "too_many", "counts_differ", "dtype", "yx_dtype",
                                  "yx_shape", "device_mix", "yx_device", "device"])
def test_levels_wrapper_rejects(case):
    img = torch.zeros((40, 40))
    yx = torch.zeros((3, 2), dtype=torch.int32)
    meta_img = torch.zeros((40, 40), device="meta")
    meta_yx = torch.zeros((3, 2), dtype=torch.int32, device="meta")
    bad = {
        "empty": ([], [], "1 to 8 images"),
        "too_many": ([img] * 9, [yx] * 9, "1 to 8 images"),
        "counts_differ": ([img, img], [yx], "as many keypoint sets"),
        "dtype": ([img.double()], [yx], "2-D float32"),
        "yx_dtype": ([img], [yx.long()], "int32"),
        "yx_shape": ([img], [torch.zeros((3, 3), dtype=torch.int32)], "int32"),
        "device_mix": ([img, meta_img], [yx, meta_yx], "different devices"),
        "yx_device": ([img], [meta_yx], "on the image's device"),
        "device": ([meta_img], [meta_yx], "unsupported device"),
    }
    images, keypoints, message = bad[case]
    with pytest.raises(ValueError, match=message):
        gather_blurred_patches_levels(images, keypoints)

