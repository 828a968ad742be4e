"""Small CPU versions of the cells, for the harness's tests."""

import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gpubench import harness  # noqa: E402


def small_vo():
    """A VO run of the ``vo_ride`` driver at 320x240 with 600 features over
    3 levels. No cell runs it (PERF.md, Open questions): the tests hold its
    extractor numbers alone, so the trajectory's limits are left open."""
    cfg = harness.config("orb2000-720p")
    cfg.update(width=320, height=240, fx=175.0, fy=175.0, cx=160.0, cy=120.0,
               orb_features=600, orb_levels=3)
    trf = dict(harness.traffic("parallax-ride-720p"), frames=40, warmup_frames=8)
    limits = {"keypoint_mismatches": 0, "descriptor_bit_mismatches": 0, "lost_frames": 0}
    limits.update(dict.fromkeys(("rotation_max_deg", "rotation_mean_deg",
                                 "centre_rmse_of_path", "normal_deg"), float("inf")))
    cell = {"config": "orb2000-720p", "traffic": "parallax-ride-720p", "chips": 1,
            "why": "the VO driver at a small size", "check_frames": 3, "limits": limits}
    return cell, cfg, trf


def small_training(name):
    """A PilotNet cell at batch 16 with 2 nets a fold and 64 examples."""
    cell = harness.cell(name)
    cfg = dict(harness.config(cell["config"]), batch_size=16)
    trf = dict(harness.traffic(cell["traffic"]), train_examples=64, val_examples=32, nets=2)
    return cell, cfg, trf


def run_small(name, specs, seconds, seed=2147483659, **kwargs):
    cell, cfg, trf = specs
    return harness.execute(name, seed, seconds, False, "cpu", time.time(), cell_spec=cell,
                           config_spec=cfg, traffic_spec=trf, **kwargs)


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
