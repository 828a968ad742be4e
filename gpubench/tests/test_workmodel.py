"""Work counted from shapes: PilotNet's FLOPs, the extractor's bytes."""

import numpy as np
import pytest

from gpubench import harness, workmodel
from gpubench.reference import pilotnet


def test_pilotnet_forward_flops():
    cfg = harness.config("pilotnet-f32")
    # convs 10.94 + 28.43 + 9.50 + 3.32 + 1.33, dense 2.68 + 0.23 + 0.01 MFLOP
    assert pilotnet.forward_flops(cfg) / 1e6 == pytest.approx(56.44, abs=0.01)


def test_pilotnet_parameters():
    cfg = harness.config("pilotnet-f32")
    shapes = pilotnet.layer_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg["parameters_per_net"]


def test_extractor_bytes_at_720p():
    cfg = harness.config("orb2000-720p")
    q = workmodel.extractor_quantities(cfg)
    fast = workmodel.kernel_files()["fast_nms"]
    # 34.2 MB for the 8 levels of a 720p frame, bound by bytes.
    assert 12 * q["pyramid_pixels"] / 1e6 == pytest.approx(34.2, abs=0.05)
    assert workmodel.kernel_bound_s(fast, q) == pytest.approx(12 * q["pyramid_pixels"] / 3.35e12)
    gather = workmodel.kernel_files()["gather_patches"]
    assert workmodel.kernel_bound_s(gather, q) is None  # covered pixels not counted yet


def test_covered_pixels_against_a_direct_count():
    rng = np.random.default_rng(0)
    yx = rng.integers(0, 60, (20, 2))
    seen = np.zeros((60, 80), bool)
    for y, x in yx:
        seen[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4] = True
    assert workmodel.covered_pixels(60, 80, yx, 3) == seen.sum()
