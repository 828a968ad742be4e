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
