"""The plain references against the program at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.reference import orb, ride


def small_frames(count=3):
    cfg = dict(harness.config("orb2000-720p"), width=320, height=240, fx=175.0, fy=175.0,
               cx=160.0, cy=120.0, orb_features=600, orb_levels=3)
    trf = dict(harness.traffic("parallax-ride-720p"), frames=count)
    return cfg, trf, ride.render_ride(trf, cfg, "cpu", 7)


def test_ride_is_the_smoke_ride():
    cfg, trf, grays = small_frames(2)
    again = ride.render_ride(trf, cfg, "cpu", 7)
    assert (grays == again).all() and grays.dtype == np.uint8
    centre, rot = ride.ride_pose(15, trf)  # a quarter of the sway period
    assert centre[0] == pytest.approx(0.9) and rot[0, 0] == pytest.approx(1.0)


def test_the_seed_draws_the_ride():
    cfg, trf, grays = small_frames(1)
    other = ride.render_ride(trf, cfg, "cpu", 2**31 + 5)
    assert (grays != other).mean() > 0.1
    assert (ride.render_ride(trf, cfg, "cpu", 2**31 + 5) == other).all()


def test_plain_extractor_equals_the_program():
    from pilotguru_tpu_torch.vo.features import extract_orb_features

    cfg, _, grays = small_frames()
    for gray in grays:
        img = torch.from_numpy(gray)
        got = extract_orb_features(img.float() / 255.0, num_levels=cfg["orb_levels"],
                                   scale=cfg["orb_scale"], threshold=20 / 255.0,
                                   total_budget=cfg["orb_features"])
        ref = orb.extract(img, cfg)
        assert torch.equal(got.valid, ref.valid) and torch.equal(got.level, ref.level)
        assert torch.equal(got.xy, ref.xy) and torch.equal(got.angle, ref.angle)
        assert torch.equal(got.descriptors, ref.descriptors)


def test_plain_extractor_in_bfloat16_is_caught():
    """The exact comparison fails an extractor computed below float32."""
    cfg, _, grays = small_frames(1)
    img = torch.from_numpy(grays[0])
    ref = orb.extract(img, cfg)
    low = orb.extract(img, cfg, dtype=torch.bfloat16)
    kp = (low.xy.double().numpy() - [cfg["cx"], cfg["cy"]]) / [cfg["fx"], cfg["fy"]]
    got = orb.compare({"kp_norm": kp, "desc": low.descriptors.numpy(),
                       "valid": low.valid.numpy(), "level": low.level.numpy()}, ref, cfg)
    assert got["keypoint_mismatches"] + got["descriptor_bit_mismatches"] > 0


def test_trajectory_errors_of_the_truth_are_zero():
    trf = harness.traffic("parallax-ride-720p")
    ids = np.arange(40)
    poses = [ride.ride_pose(int(i), trf) for i in ids]
    rot_c2w = [r.T for _, r in poses]
    quats = []
    for m in rot_c2w:
        w = np.sqrt(max(1 + np.trace(m), 0)) / 2
        quats.append([w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
                      (m[1, 0] - m[0, 1]) / (4 * w)])
    traj = {"frame_id": ids, "translations": np.stack([c for c, _ in poses]),
            "rotations": np.array(quats), "plane": np.array([[1.0, 0, 0], [0, 0, 1.0]])}
    errors = ride.trajectory_errors(traj, trf)
    assert max(errors.values()) < 1e-5  # arccos near 1 resolves about 1e-6 degrees
