"""The port's data CLIs (interpolate_velocity, integrate_motion,
annotate_frames, smooth_heading_directions, project_translations,
process_can_frames, preprocess_all, make_linear_adjusted_label_shift) and
their modules, against the JAX package and its goldens, on the CPU in
float64.

Goldens (tests/golden/expected, made by the JAX package on the CPU with
x64): annotate_frames, process_can_frames, project_translations,
smooth_heading_directions and interpolate_velocity are byte-identical: the
port repeats XLA's CPU arithmetic where it matters (the blocked cumulative
sum of the interval averages; the fused multiply-adds of the quaternion
filter, of its norm and of each descent step; the closed-form gradient
summed in the order of JAX's reverse pass). integrate_motion agrees within
1e-12 m/s, not bit for bit: its velocities come from the port's
doubling-step quaternion scan and cumulative sum, which associate
differently from XLA's scans (measured: 5.7e-14 m/s).
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from pilotguru_tpu.calib import integrate as jintegrate
from pilotguru_tpu.calib import interpolate as jinterp
from pilotguru_tpu.cli import annotate_frames as jannotate_cli
from pilotguru_tpu.cli import make_linear_adjusted_label_shift as jshift_cli
from pilotguru_tpu.formats import can as jcan
from pilotguru_tpu.timeseries import interval_average as jia
from pilotguru_tpu.vo import flatten as jflatten
from pilotguru_tpu_torch.calib import integrate as tintegrate
from pilotguru_tpu_torch.calib import interpolate as tinterp
from pilotguru_tpu_torch.cli import annotate_frames as tannotate_cli
from pilotguru_tpu_torch.cli import fit_motion as tfit_cli
from pilotguru_tpu_torch.cli import integrate_motion as tintegrate_cli
from pilotguru_tpu_torch.cli import interpolate_velocity as tinterp_cli
from pilotguru_tpu_torch.cli import make_linear_adjusted_label_shift as tshift_cli
from pilotguru_tpu_torch.cli import preprocess_all as tpreprocess_cli
from pilotguru_tpu_torch.cli import process_can_frames as tcan_cli
from pilotguru_tpu_torch.cli import project_translations as tproject_cli
from pilotguru_tpu_torch.cli import smooth_heading_directions as tsmooth_cli
from pilotguru_tpu_torch.formats import can as tcan
from pilotguru_tpu_torch.formats import json_io as tjson
from pilotguru_tpu_torch.timeseries import interval_average as tia
from pilotguru_tpu_torch.vo import flatten as tflatten

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
EXPECTED = os.path.join(REPO, "tests", "golden", "expected")
RIDE = os.path.join(INPUTS, "ride")
GOLDEN_FLOAT_BAR = 1e-12  # m/s; see the module docstring

GOLDEN_CASES = {
    "annotate_frames": (tannotate_cli, lambda o: [
        f"--frames_json={RIDE}/frames.json", f"--in_json={RIDE}/locations.json",
        "--json_root_element_name=locations", "--json_value_name=speed_m_s",
        f"--out_json={o}/annotated.json"], ["annotated.json"]),
    "process_can_frames": (tcan_cli, lambda o: [
        f"--can_frames_json={INPUTS}/can.json", f"--steering_out_json={o}/can_steering.json",
        f"--velocities_out_json={o}/can_velocities.json",
        "--velocity_scale_can_units_to_m_s=0.01"], ["can_steering.json", "can_velocities.json"]),
    "smooth_heading_directions": (tsmooth_cli, lambda o: [
        f"--trajectory_in_file={INPUTS}/trajectory.json", "--sigma=2",
        f"--trajectory_out_file={o}/trajectory_smoothed.json"], ["trajectory_smoothed.json"]),
    "project_translations": (tproject_cli, lambda o: [
        f"--trajectory_in_file={INPUTS}/trajectory.json",
        f"--trajectory_out_file={o}/trajectory_projected.json"], ["trajectory_projected.json"]),
    "integrate_motion": (tintegrate_cli, lambda o: [
        f"--rotations_json={RIDE}/rotations.json", f"--accelerations_json={RIDE}/accelerations.json",
        f"--out_json={o}/integrated.json"], ["integrated.json"]),
    "interpolate_velocity": (tinterp_cli, lambda o: [
        f"--locations_json={RIDE}/locations.json", f"--frames_json={RIDE}/frames.json",
        f"--out_json={o}/interpolated.json", "--l1_weight=1.0", "--iters=200"],
        ["interpolated.json"]),
}
BYTE_IDENTICAL = ("annotate_frames", "process_can_frames", "smooth_heading_directions",
                  "project_translations", "interpolate_velocity")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")


@pytest.mark.parametrize("name", BYTE_IDENTICAL)
def test_golden_is_byte_identical(name, tmp_path):
    cli, argv, outputs = GOLDEN_CASES[name]
    assert cli.main(argv(tmp_path)) == 0
    for out in outputs:
        got = (tmp_path / out).read_bytes()
        assert got == open(os.path.join(EXPECTED, out), "rb").read(), out


@pytest.mark.parametrize("name", ["integrate_motion"])
def test_golden_within_rounding(name, tmp_path):
    cli, argv, outputs = GOLDEN_CASES[name]
    assert cli.main(argv(tmp_path)) == 0
    got = tjson.read_json(str(tmp_path / outputs[0]))["frames"]
    want = tjson.read_json(os.path.join(EXPECTED, outputs[0]))["frames"]
    assert [{k: v for k, v in e.items() if k != "speed_m_s"} for e in got] == \
        [{k: v for k, v in e.items() if k != "speed_m_s"} for e in want]
    np.testing.assert_allclose([e["speed_m_s"] for e in got], [e["speed_m_s"] for e in want],
                               rtol=0, atol=GOLDEN_FLOAT_BAR)


# ---- interpolate ---------------------------------------------------------------------------


def _gps_and_frames(seed, duration=20.0):
    rng = np.random.default_rng(seed)
    gps_t = 1_000_000 + np.cumsum(rng.integers(900_000, 1_100_000, int(duration)))
    speeds = 8.0 + 3.0 * np.sin(np.arange(gps_t.size) / 4.0) + rng.normal(0, 0.3, gps_t.size)
    frame_t = 1_200_000 + np.cumsum(rng.integers(30_000, 36_000, int(duration * 30)))
    return gps_t.astype(np.int64), speeds, frame_t.astype(np.int64)


@pytest.mark.parametrize("settings", [
    dict(l1_weight=1.0, iters=150),
    dict(l1_weight=0.5, distance_weight=2.0, accelerations_weight=0.5,
         accelerations_smoothness_weight=3.0, learning_rate_decay=0.99, iters=150),
    # With an L2 term the smoothness gradient (of order 1/dt^4) dwarfs the
    # clip, so the descent runs clipped oscillations in which rounding
    # differences grow from step to step (to 1e-6 m/s after 150 steps with
    # decay): ten steps.
    dict(l1_weight=0.5, l2_weight=0.5, learning_rate=0.02, learning_rate_decay=0.99, iters=10),
])
def test_interpolate_matches_reference(settings):
    gps_t, speeds, frame_t = _gps_and_frames(1)
    want = jinterp.interpolate_gps_velocities(gps_t, speeds, frame_t,
                                              jinterp.InterpolationSettings(**settings))
    got = tinterp.interpolate_gps_velocities(gps_t, speeds, frame_t,
                                             tinterp.InterpolationSettings(**settings),
                                             device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_interpolate_first_step_takes_the_reference_sign_at_zero():
    """One descent step from InitToAverages, where every acceleration is
    exactly 0 inside a GPS interval: with d|0| = -1 (the reference's
    convention) the step moves those frames, and it is the JAX package's
    step to the bit; with torch.abs's d|0| = 0 it would not move them."""
    gps_t, speeds, frame_t = _gps_and_frames(2)
    settings = dict(l1_weight=1.0, iters=1)
    want = jinterp.interpolate_gps_velocities(gps_t, speeds, frame_t,
                                              jinterp.InterpolationSettings(**settings))
    got = tinterp.interpolate_gps_velocities(gps_t, speeds, frame_t,
                                             tinterp.InterpolationSettings(**settings),
                                             device="cpu")
    np.testing.assert_array_equal(got, want)
    start = tinterp.interpolate_gps_velocities(gps_t, speeds, frame_t,
                                               tinterp.InterpolationSettings(l1_weight=1.0,
                                                                             iters=0),
                                               device="cpu")
    assert np.mean(got != start) > 0.9
    zero = torch.zeros(3, dtype=torch.float64)
    np.testing.assert_array_equal(tinterp.reference_sign(zero).numpy(), [-1.0, -1.0, -1.0])


def test_interpolate_refuses_zero_weights():
    gps_t, speeds, frame_t = _gps_and_frames(3)
    with pytest.raises(ValueError, match="must be positive"):
        tinterp.interpolate_gps_velocities(gps_t, speeds, frame_t, device="cpu")


# ---- integrate -----------------------------------------------------------------------------


@pytest.mark.parametrize("imu_hz,seed", [(20.0, 3)])
def test_integrate_matches_reference(imu_hz, seed):
    r = synthetic.make_ride(duration_sec=20.0, imu_hz=imu_hz, jitter_seed=seed,
                            local_bias=(0.05, -0.1, 0.2))
    args = (r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations)
    want_t, want_v = jintegrate.integrate_motion_debiased(*args)
    got_t, got_v = tintegrate.integrate_motion_debiased(*args, device="cpu")
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-11)


# ---- interval averages and annotate_frames -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_interval_averages_match_reference(seed):
    """Random series and queries, some bounds on sample times, some outside
    the series (invalid)."""
    rng = np.random.default_rng(seed)
    times = 5_000_000 + np.cumsum(rng.integers(1, 200_000, 400)).astype(np.int64)
    values = rng.normal(size=times.size)
    q0 = np.sort(rng.integers(times[0] - 1_000_000, times[-1], 300)).astype(np.int64)
    q0[::7] = times[rng.integers(0, times.size, q0[::7].size)]
    q1 = q0 + rng.integers(1, 300_000, q0.size)
    q1[::5] = np.minimum(times[rng.integers(1, times.size, q1[::5].size)], q1[::5] + 10**9)
    q1 = np.maximum(q1, q0 + 1)
    want, want_valid = jia.time_averaged_values(values, times, q0, q1)
    got, got_valid = tia.time_averaged_values(values, times, q0, q1, device="cpu")
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    ok = np.asarray(want_valid)
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 4097, 54_000])
def test_blocked_cumsum_repeats_the_reference_order(n):
    rng = np.random.default_rng(n)
    x = rng.random(n) * rng.choice([1.0, 1e3, 1e-3], n)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(tia.blocked_cumsum(torch.as_tensor(x)).numpy(), want)


def test_annotate_bounds_come_from_microseconds_in_float32():
    """A 30-minute ride where frames fall on sample times: in float32 the
    averages follow float64's to float32 rounding, boundaries included."""
    times = (np.arange(0, 1_800_000_000 + 1, 100_000) + 7).astype(np.int64)  # 10 Hz
    values = np.sin(times * 1e-7)
    frames = (np.arange(0, 1_800_000_000, 33_333) + 7).astype(np.int64)
    frames[::3] = times[(frames[::3] - 7) // 100_000]  # on a sample
    f64, v64 = tia.annotate_frames_values(times, values, frames, device="cpu")
    f32, v32 = tia.annotate_frames_values(times, values, frames, dtype=torch.float32,
                                          device="cpu")
    np.testing.assert_array_equal(v32.numpy(), v64.numpy())
    assert np.abs(f32.numpy() - f64.numpy()).max() < 2e-3


def test_annotate_cli_with_smoothing_matches_reference_cli(tmp_path):
    """The smoothing's banded weighted sum associates differently from
    XLA's (held to 1e-13 on unit values in test_torch_fit_motion), so the
    speeds of about 10 m/s agree to 1e-11, not bit for bit."""
    argv = [f"--frames_json={RIDE}/frames.json", f"--in_json={RIDE}/locations.json",
            "--json_root_element_name=locations", "--json_value_name=speed_m_s",
            "--smoothing_sigma=0.7"]
    assert jannotate_cli.main(argv + [f"--out_json={tmp_path}/jax.json"]) == 0
    assert tannotate_cli.main(argv + [f"--out_json={tmp_path}/port.json"]) == 0
    got = tjson.read_json(str(tmp_path / "port.json"))["locations"]
    want = tjson.read_json(str(tmp_path / "jax.json"))["locations"]
    assert [e["frame_id"] for e in got] == [e["frame_id"] for e in want]
    np.testing.assert_allclose([e["speed_m_s"] for e in got], [e["speed_m_s"] for e in want],
                               rtol=0, atol=1e-11)


# ---- trajectories, CAN, the wrappers -------------------------------------------------------


def test_project_translations_matches_reference():
    rng = np.random.default_rng(4)
    t = rng.normal(size=(50, 3))
    plane = np.linalg.qr(rng.normal(size=(3, 3)))[0][:2]
    np.testing.assert_array_equal(tflatten.project_translations(t, plane),
                                  jflatten.project_translations(t, plane))


def test_can_parsing_matches_reference():
    rng = np.random.default_rng(5)
    texts = ["2B0 64 00 00 00 00", "4B0 01 80 FF 7F 00 00 10 27", "2B0 64 00", "2B0  64",
             "zz 01", "4B0 01 02 03 04 05 06 07 08 09", "123 ", "2B0 6"]
    for _ in range(200):
        n = int(rng.integers(0, 10))
        texts.append(rng.choice(["2B0", "4B0", "7FF"]) + "".join(
            f" {int(b):02X}" for b in rng.integers(0, 256, n)))
    for text in texts:
        want = jcan.try_parse_can_frame(text)
        assert tcan.try_parse_can_frame(text) == want, text
        if want is not None:
            assert tcan.parse_steering_angle_degrees(want[1]) == \
                jcan.parse_steering_angle_degrees(want[1])
            assert tcan.parse_average_wheel_speed(want[1]) == \
                jcan.parse_average_wheel_speed(want[1])


def test_preprocess_all_runs_fit_motion_and_can_in_process(tmp_path):
    """The wrapper's outputs are the port's fit_motion and process_can_frames
    CLIs' own, byte for byte."""
    ride = tmp_path / "ride"
    ride.mkdir()
    for name in ("rotations.json", "accelerations.json", "locations.json"):
        (ride / name).write_bytes(open(os.path.join(RIDE, name), "rb").read())
    (ride / "can_frames.json").write_bytes(open(os.path.join(INPUTS, "can.json"), "rb").read())
    assert tpreprocess_cli.main([f"--in_dir={ride}", "--process_can_data=true"]) == 0
    out = ride / "postprocessed"
    direct = tmp_path / "direct"
    direct.mkdir()
    assert tfit_cli.main([
        f"--rotations_json={ride}/rotations.json",
        f"--accelerations_json={ride}/accelerations.json",
        f"--locations_json={ride}/locations.json",
        f"--velocities_out_json={direct}/velocities-imu.json",
        f"--steering_out_json={direct}/steering-imu.json",
        f"--forward_axis_out_json={direct}/forward.json"]) == 0
    assert tcan_cli.main([f"--can_frames_json={ride}/can_frames.json",
                          f"--steering_out_json={direct}/steering-can.json",
                          f"--velocities_out_json={direct}/velocities-can.json"]) == 0
    for name in ("velocities-imu.json", "steering-imu.json", "forward.json",
                 "steering-can.json", "velocities-can.json"):
        assert (out / name).read_bytes() == (direct / name).read_bytes(), name


@pytest.mark.parametrize("argv", [[], ["--start_value=0.5", "--end_value=2", "--dims=4"],
                                  ["--start_value=-1", "--dims=3"]])
def test_label_shift_prints_the_reference_line(argv):
    outs = []
    for cli in (jshift_cli, tshift_cli):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["annotate_frames", "integrate_motion",
                                  "interpolate_velocity", "smooth_heading_directions"])
def test_device_clis_run_on_the_card_unless_asked_for_the_cpu(name, tmp_path, monkeypatch):
    """Unset, the platform is cuda: without a card these CLIs raise instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("PILOTGURU_TPU_PLATFORM", raising=False)
    cli, argv, _ = GOLDEN_CASES[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv(tmp_path))


def test_json_readers_match_reference():
    from pilotguru_tpu.formats import json_io as jjson

    np.testing.assert_array_equal(tjson.read_frames(f"{RIDE}/frames.json")[0],
                                  jjson.read_frames(f"{RIDE}/frames.json")[0])
    np.testing.assert_array_equal(tjson.read_frames(f"{RIDE}/frames.json")[1],
                                  jjson.read_frames(f"{RIDE}/frames.json")[1])
    for got, want in zip(tjson.read_timestamped_values(f"{RIDE}/locations.json", "locations",
                                                       "speed_m_s"),
                         jjson.read_timestamped_values(f"{RIDE}/locations.json", "locations",
                                                       "speed_m_s")):
        np.testing.assert_array_equal(got, want)
    axis = os.path.join(EXPECTED, "forward_axis.json")
    np.testing.assert_array_equal(tjson.read_forward_axis(axis), jjson.read_forward_axis(axis))
    data = json.load(open(os.path.join(EXPECTED, "annotated.json")))
    assert tjson.dumps(data) == jjson.dumps(data)


def test_interpolate_on_the_smoke_ride_matches_reference():
    """chip_smoke's 300 s ride (bench.py's, with sensor noise), frames at
    30 fps, interpolate_velocity's defaults with --l1_weight=1 (1,000 steps):
    the port's speeds are the JAX package's to the bit, so the frame RMSE
    against the true speed that chip_smoke reads on the card (0.92 m/s here,
    INTERPOLATION_BARS) is the reference method's own."""
    import chip_smoke

    arrays, true_speed = chip_smoke.make_imu_ride(300.0, seed=100)
    gps_t, gps = arrays[4], arrays[5]
    frame_t = np.arange(arrays[0][0] + 1850, arrays[0][-1], 1e6 / 30).astype(np.int64)
    want = jinterp.interpolate_gps_velocities(gps_t, gps, frame_t,
                                              jinterp.InterpolationSettings(l1_weight=1.0))
    got = tinterp.interpolate_gps_velocities(gps_t, gps, frame_t,
                                             tinterp.InterpolationSettings(l1_weight=1.0),
                                             device="cpu")
    np.testing.assert_array_equal(got, want)
    errors = chip_smoke.interpolation_errors(frame_t, got, gps_t, true_speed)
    assert 0.5 < errors["frame_rmse"] <= chip_smoke.INTERPOLATION_BARS["frame_rmse"], errors
    assert errors["interval_rmse"] <= chip_smoke.INTERPOLATION_BARS["interval_rmse"], errors
