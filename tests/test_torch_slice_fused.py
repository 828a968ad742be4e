"""The fused configuration end to end on the golden video:
PGTPU_PATCH_IMPL=fused (the extractor's fused blur + patch gather, K3) with
loop closing on, the port's optical_trajectories CLI against the JAX
package's per-frame run of the same configuration (its Pallas K3 in
interpret mode), with the reference's RANSAC draws replayed into the port
(tests/test_torch_slice_replay.py has the machinery).

Unlike the default configuration, this one does not follow the reference
to a tenth of a degree. The features agree (over the 120 frames, 2 of the
port's descriptors differ from the reference's, by 1 and 2 bits; angles
within 1.1e-4 rad), but the two-view initialization sits on a near-tie:
the reference solves it in float32, the port in float64, and on frame 1
one of 141 inliers flips. Fed identical features, the two trackers'
frame-1 poses then differ by 6.7e-4 and the runs drift apart from there.

Measured: port against the JAX run, per-frame rotation max 1.827 degrees
(mean 0.532), centre RMSE 1.78% of the path, normal 1.411 degrees (the
draws alone move runs of this video by 1.783 degrees, ROADMAP Queue 3);
against the golden, port 1.052 and JAX 1.345 degrees worst rotation; no
loop closes on either side. The bars sit above those readings.
"""

import pytest
from test_torch_slice_replay import (
    GOLDEN,
    assert_port_follows_reference,
    jax_per_frame_run,
    port_replayed_run,
    rotation_degrees,
)

from pilotguru_tpu.formats.trajectory import read_trajectory

FUSED = {"PGTPU_PATCH_IMPL": "fused"}


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    jax_run = jax_per_frame_run(str(tmp_path_factory.mktemp("jax_fused")), FUSED)
    port_run = port_replayed_run(str(tmp_path_factory.mktemp("port_fused")), FUSED)
    return port_run, jax_run


def test_fused_port_against_reference(fused_runs):
    (port, port_trackers, _), (ref, jax_trackers) = fused_runs
    assert len(ref) == 120
    assert port_trackers[0].config.patch_impl == "fused"
    assert_port_follows_reference(port, ref, rot_max=2.0, rot_mean=0.6,
                                  rmse_of_path=0.025, normal_deg=2.0)
    assert [t.stats["loop_closures"] for t in port_trackers] == [0]
    assert [t.stats["loop_closures"] for t in jax_trackers] == [0]


def test_fused_rotation_against_golden_within_the_draws(fused_runs):
    """As test_torch_slice_replay: no farther from the golden than the JAX
    run of the same configuration, plus 0.1 degrees."""
    golden = read_trajectory(GOLDEN)
    port, ref = fused_runs[0][0], fused_runs[1][0]
    port_rot = rotation_degrees(port.rotations, golden.rotations)
    ref_rot = rotation_degrees(ref.rotations, golden.rotations)
    assert port_rot.max() <= ref_rot.max() + 0.1
    assert port_rot.mean() <= ref_rot.mean() + 0.1
