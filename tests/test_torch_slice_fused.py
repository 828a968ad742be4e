"""The fused configuration end to end on the golden video:
PGTPU_PATCH_IMPL=fused (the extractor's fused blur + patch gather, K3) with
loop closing on, the port's optical_trajectories CLI against the JAX
package's per-frame run of the same configuration (its Pallas K3 in
interpret mode), with the reference's RANSAC draws replayed into the port
(tests/test_torch_slice_replay.py has the machinery).

In this configuration the two-view initialization sits on a near-tie: on
frame 1 one of 141 inliers flips between the reference's solve and the
port's, the two maps start different and the runs drift apart. The features
are not the cause (over the 120 frames 2 of the port's descriptors differ
from the reference's, by 1 and 2 bits; angles within 1.1e-4 rad). Measured,
port against the JAX run, per-frame rotation max / mean in degrees, centre
RMSE as a share of the path, plane normal in degrees:

  * the port's own two-view solve in float64 (the CPU's geometry dtype):
    1.827 / 0.532, 1.78%, 1.411; frame 1 differs by 0.0190 degrees;
  * the port's own solve in float32, the dtype the reference solves it in
    (its keypoints' dtype) and the dtype of the card: 0.924 / 0.223, 0.61%,
    0.306; frame 1 differs by 0.0011 degrees, but LAPACK's and XLA's
    float32 SVDs still do not resolve the tie alike and frame 2 is 0.039
    degrees off;
  * the reference's two-view results replayed into the port, as its draws
    are: 0.0047 / 0.00017, 0.00009%, 0.00003. Everything after the
    initialization follows the reference as closely as on the default path
    (0.033 degrees there).

So the first test replays the two-view results and holds the rest of the
run to the default path's bars; the last keeps the port's own solve, in
float32, under the bars this file held before (the draws alone move runs of
this video by 1.783 degrees). Against the golden the JAX run reads 1.345
degrees worst rotation, the port 1.345 (replayed) and 1.087 (own float32
solve); no loop closes on either side.
"""

import pytest
import torch
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
    two_view_log = []
    jax_run = jax_per_frame_run(str(tmp_path_factory.mktemp("jax_fused")), FUSED,
                                two_view_log=two_view_log)
    assert len(two_view_log) >= 1
    port_run = port_replayed_run(str(tmp_path_factory.mktemp("port_fused")), FUSED,
                                 two_view_log=two_view_log)
    assert port_run[2]["two_view"] == len(two_view_log)
    return port_run, jax_run


def test_fused_port_against_reference(fused_runs):
    """Two-view results replayed: the default path's bars
    (test_port_follows_reference_tracker). Measured: 0.0047 and 0.00017
    degrees, 9.0e-7 of the path, 0.00003 degrees."""
    (port, port_trackers, _), (ref, jax_trackers) = fused_runs
    assert len(ref) == 120
    assert port_trackers[0].config.patch_impl == "fused"
    assert_port_follows_reference(port, ref, rot_max=0.1, rot_mean=0.01,
                                  rmse_of_path=1e-3, normal_deg=0.1)
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


def test_fused_port_with_its_own_two_view(fused_runs, tmp_path):
    """The port's own two-view solve (draws replayed, solved in float32 as
    the reference and the card do): the near-tie resolves the other way, and
    the run stays within the draws' spread of the reference and no farther
    from the golden than the reference. Measured: 0.924 and 0.223 degrees,
    0.61% of the path, 0.306 degrees; 1.087 degrees from the golden."""
    port, port_trackers, calls = port_replayed_run(str(tmp_path), FUSED,
                                                   two_view_dtype=torch.float32)
    ref = fused_runs[1][0]
    assert calls["two_view"] >= 1
    assert_port_follows_reference(port, ref, rot_max=2.0, rot_mean=0.6,
                                  rmse_of_path=0.025, normal_deg=2.0)
    assert [t.stats["loop_closures"] for t in port_trackers] == [0]
    golden = read_trajectory(GOLDEN)
    port_rot = rotation_degrees(port.rotations, golden.rotations)
    ref_rot = rotation_degrees(ref.rotations, golden.rotations)
    assert port_rot.max() <= ref_rot.max() + 0.1
    assert port_rot.mean() <= ref_rot.mean() + 0.1
