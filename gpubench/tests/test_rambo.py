"""The Rambo cell: its reference's sizes, its run at a small size on the CPU
(sound, and not correct under each planted fault of the train step), its
readers, and, on the card, the TF32 control failing."""

import time

import numpy as np
import pytest

from gpubench import harness
from gpubench.drivers import rambo as driver
from gpubench.metrics import train_bn_relu_roofline, train_step_host_ms
from gpubench.reference import rambo
from gpubench.tests.conftest import run_small
from gpubench.tests.test_faults import broken_step

CELL = "rambo-train-x3-b1024"


def small_rambo():
    """The Rambo cell at batch 8 with 2 nets, 32 examples and 16 for
    validation; the configuration's widths and crop. The cell's limits are
    set at batch 1,024 on the card; batch norm over 8 examples amplifies
    the CPU's float32 rounding more: over four seeds the loss gap read
    1.3e-6 to 3.2e-5 (the run's seed 1.3e-6), the gradient and change gaps
    at most 5.2e-4 and 6.9e-4."""
    cell = harness.cell(CELL)
    cfg = dict(harness.config(cell["config"]), batch_size=8)
    trf = dict(harness.traffic(cell["traffic"]), train_examples=32, val_examples=16, nets=2)
    return cell, cfg, trf


def test_rambo_sizes():
    cfg = harness.config("rambo-f32")
    shapes = rambo.layer_shapes(cfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg["parameters_per_net"]
    # Convs: comma 24.79 + PilotNet-style 124.50 + four-conv 199.59 MFLOP;
    # dense layers to the heads 3.16 + 0.10 + 0.88 MFLOP.
    assert rambo.forward_flops(cfg) / 1e6 == pytest.approx(353.01, abs=0.01)
    sizes = rambo.batch_norm_sizes(cfg)
    assert len(sizes) == 17 and sum(v for _, v, _ in sizes) == 648_780
    # x, g read and y, dx written: 31.9 GB a step at x3, batch 1,024, float32.
    assert driver.bn_relu_bytes_per_step(cfg, 3) == 4 * 4 * 1024 * 3 * 648_780


@pytest.fixture(scope="module")
def rambo_sound():
    return run_small(CELL, small_rambo(), 3)


def test_rambo_training_sound(rambo_sound):
    assert all(c.ok for c in rambo_sound.checks), rambo_sound.checks
    assert rambo_sound.notes["steps"] == 4  # one epoch of 32 examples at batch 8


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_rambo_fault_is_caught(monkeypatch, fault):
    broken_step(monkeypatch, fault)
    outcome = run_small(CELL, small_rambo(), 3)
    assert not all(c.ok for c in outcome.checks), outcome.checks


def test_readers_read_only_a_traced_run_with_the_pair():
    """Neither reader reads the PilotNet cells' layer (no tallies or step
    spans); the roofline reads only where the pair ran."""

    class Trace:
        by_name = {"void bn_stats_kernel<float, 4, false>(PgBn)": (10, 0.004),
                   "void bn_apply_kernel<float, 4, true>(PgBn, int)": (10, 0.006),
                   "sm80_xmma_fprop": (10, 1.0)}

    pilotnet = {"train": {"steps": 2, "window_s": 1.0, "net_examples": 10, "trace": Trace(),
                          "flops_per_net_example": 1}}
    for reader in (train_bn_relu_roofline, train_step_host_ms):
        assert reader.read(pilotnet) is None and reader.read({}) is None
    traced = {"train": dict(pilotnet["train"], tallies={"folded.bn_fused": 34},
                            step_spans=[(0, 3_000_000), (5_000_000, 6_000_000)],
                            bn_relu_bytes_per_step=3.35e9)}
    # 2 steps x 1 ms at the memory rate, over 10 ms of the pair's kernels.
    assert train_bn_relu_roofline.read(traced) == pytest.approx(20.0)
    assert train_step_host_ms.read(traced) == pytest.approx(2.0)
    parent = {"train": dict(traced["train"], tallies={"train.steps": 2})}
    assert train_bn_relu_roofline.read(parent) is None
    assert train_step_host_ms.read(parent) == pytest.approx(2.0)


@pytest.mark.cuda
def test_rambo_tf32_control_fails(cuda_device):
    """Three steps at the cell's own batch and net count, on three batches
    of data."""
    cell = harness.cell(CELL)
    cfg = harness.config(cell["config"])
    trf = dict(harness.traffic(cell["traffic"]), train_examples=3 * cfg["batch_size"],
               val_examples=cfg["batch_size"])
    runs = {precision: harness.execute(CELL, 3, 1, False, cuda_device, time.time(),
                                       cell_spec=cell, config_spec=cfg, traffic_spec=trf,
                                       precision=precision)
            for precision in ("float32", "tf32")}
    assert all(c.ok for c in runs["float32"].checks), runs["float32"].checks
    assert not all(c.ok for c in runs["tf32"].checks), runs["tf32"].checks
