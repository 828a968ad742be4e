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
