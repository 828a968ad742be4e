"""K2 (per-keypoint patch gather): the port's plain PyTorch version against
the JAX package's extract_patches and its Pallas kernel in interpret mode,
exactly (the CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.vo.features import extract_patches
from pilotguru_tpu.vo.patch_pallas import gather_patches_pallas
from pilotguru_tpu_torch.vo import patch_kernel
from pilotguru_tpu_torch.vo.patch_kernel import gather_patches, gather_patches_plain

torch.set_num_threads(1)


def _check(img, yx, pallas=True):
    got = gather_patches(torch.from_numpy(img), torch.from_numpy(yx)).numpy()
    want = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    np.testing.assert_array_equal(got, want)
    if pallas:
        p = np.asarray(gather_patches_pallas(jnp.asarray(img), jnp.asarray(yx), 39,
                                             interpret=True))
        np.testing.assert_array_equal(got, p)
    assert got.shape == (yx.shape[0], 39, 39)


@pytest.mark.parametrize("k", [1, 7, 8, 37])
def test_matches_reference(k):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, size=(120, 160)).astype(np.float32)
    yx = np.stack([rng.integers(0, 120, k), rng.integers(0, 160, k)], axis=1)
    _check(img, yx.astype(np.int32))


def test_edge_keypoints():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, size=(64, 96)).astype(np.float32)
    yx = np.array([[0, 0], [0, 95], [63, 0], [63, 95], [31, 47]], np.int32)
    _check(img, yx)


def test_starts_past_the_image_clamp_like_dynamic_slice():
    """Starts past the image's far edge clamp as dynamic_slice clamps them.
    (Negative starts are outside the contract: the reference's jnp gather
    wraps them like numpy indices, its Pallas kernel clips them to 0; the
    extractor only ever passes in-image keypoints.)"""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, size=(50, 70)).astype(np.float32)
    yx = np.array([[80, 3], [10, 200], [49, 69], [120, 300]], np.int32)
    _check(img, yx, pallas=False)


def test_cpu_dispatch_runs_plain_version_without_launching():
    patch_kernel.COUNTER.reset()
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, size=(40, 60)).astype(np.float32))
    yx = torch.tensor([[3, 4], [39, 59]], dtype=torch.int32)
    assert torch.equal(gather_patches(img, yx, 5), gather_patches_plain(img, yx, 5))
    assert patch_kernel.COUNTER.launches == 0
    assert patch_kernel.COUNTER.plain_cuda_calls == 0



@pytest.mark.parametrize("num_levels", [1, 3, 8])
def test_levels_cpu_dispatch_runs_plain_per_level_without_launching(num_levels):
    """gather_patches_levels on CPU tensors is the plain version level by
    level (each equal to the reference's extract_patches), with no launch;
    a level without keypoints gives an empty [0, 39, 39]."""
    rng = np.random.default_rng(6)
    shapes = [(60 - 5 * level, 90 - 8 * level) for level in range(num_levels)]
    images = [rng.uniform(0, 1, size=s).astype(np.float32) for s in shapes]
    yx = [np.concatenate([
        np.stack([rng.integers(0, h, 9), rng.integers(0, w, 9)], axis=1),
        np.array([[0, 0], [h - 1, w - 1]]),
    ]).astype(np.int32) for h, w in shapes]
    if num_levels > 1:
        yx[1] = yx[1][:0]
    patch_kernel.COUNTER.reset()
    got = patch_kernel.gather_patches_levels(
        [torch.from_numpy(i) for i in images], [torch.from_numpy(p) for p in yx])
    assert patch_kernel.COUNTER.launches == 0
    assert patch_kernel.COUNTER.plain_cuda_calls == 0
    assert len(got) == num_levels
    for patches, img, level_yx in zip(got, images, yx):
        assert patches.shape == (level_yx.shape[0], 39, 39)
        want = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(level_yx)))
        np.testing.assert_array_equal(patches.numpy(), want.reshape(patches.shape))


def test_levels_refuse_bad_arguments():
    img = torch.zeros((20, 30))
    yx = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="want 1 to 8 images"):
        patch_kernel.gather_patches_levels([img] * 9, [yx] * 9)
    with pytest.raises(ValueError, match="as many keypoint sets"):
        patch_kernel.gather_patches_levels([img, img], [yx])
    with pytest.raises(ValueError, match="int32"):
        patch_kernel.gather_patches_levels([img], [yx.long()])
