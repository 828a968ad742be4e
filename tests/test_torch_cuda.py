"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. This file imports
nothing of JAX, and tests/conftest.py does, so on the card (which has no
JAX) run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pilotguru_tpu_torch.vo.fast_kernel import fast_nms, fast_nms_plain
from pilotguru_tpu_torch.vo.features import extract_orb_features
from pilotguru_tpu_torch.vo.patch_kernel import gather_patches, gather_patches_plain

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


@pytest.mark.cuda
def test_patch_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.uniform(0, 1, size=(720, 1280)).astype(np.float32)).to(cuda)
    yx = np.stack([rng.integers(-3, 723, 434), rng.integers(-3, 1283, 434)], axis=1)
    yx = torch.from_numpy(yx.astype(np.int32)).to(cuda)
    assert torch.equal(gather_patches(img, yx), gather_patches_plain(img, yx))


@pytest.mark.cuda
def test_extractor_cuda_matches_cpu(cuda):
    """Every extractor stage is device-independent except the orientation
    moment sums (reduction order), which can flip a descriptor only for an
    angle at a steering-bin edge."""
    rng = np.random.default_rng(7)
    img = np.zeros((360, 640), np.float32)
    for _ in range(300):
        y, x = rng.integers(0, 350), rng.integers(0, 630)
        img[y : y + rng.integers(3, 12), x : x + rng.integers(3, 12)] = rng.uniform()
    cpu = extract_orb_features(torch.from_numpy(img), num_levels=4, total_budget=800)
    gpu = extract_orb_features(torch.from_numpy(img).to(cuda), num_levels=4,
                               total_budget=800)
    assert torch.equal(cpu.valid, gpu.valid.cpu())
    assert torch.equal(cpu.level, gpu.level.cpu())
    assert torch.equal(cpu.xy, gpu.xy.cpu())
    torch.testing.assert_close(cpu.angle, gpu.angle.cpu(), atol=1e-5, rtol=0)
    same = (cpu.descriptors == gpu.descriptors.cpu()).all(dim=1)
    assert float(same[cpu.valid].float().mean()) >= 0.995
