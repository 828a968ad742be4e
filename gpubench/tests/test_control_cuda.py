"""The control, the program with TF32 switched on, comes out not correct
where the configuration states float32 with TF32 off. On the card only
(TF32 exists there): python -m pytest gpubench/tests -m cuda"""

import time

import pytest

from gpubench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pilotnet-train-x3-b1024", "pilotnet-search-x12-b1024"])
def test_tf32_control_fails(cuda_device, name):
    """Three steps at the cell's own batch and net count, on three batches
    of data."""
    cell = harness.cell(name)
    cfg = harness.config(cell["config"])
    trf = dict(harness.traffic(cell["traffic"]), train_examples=3 * cfg["batch_size"],
               val_examples=cfg["batch_size"])
    runs = {precision: harness.execute(name, 3, 1, False, cuda_device, time.time(),
                                       cell_spec=cell, config_spec=cfg, traffic_spec=trf,
                                       precision=precision)
            for precision in ("float32", "tf32")}
    assert all(c.ok for c in runs["float32"].checks), runs["float32"].checks
    assert not all(c.ok for c in runs["tf32"].checks), runs["tf32"].checks
