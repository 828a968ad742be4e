"""fit_motion (IMU + GPS calibration): the port against the JAX package on
the CPU, module by module and as a whole, on the same numpy inputs, both in
float64.

Tolerances. The port's scans, cumulative sums and reductions associate
differently from XLA's (the quaternion scan above all), so floats agree to
rounding, not bit for bit; integer outputs (pieces, window indices, event
times) match exactly. On a ride with vertical motion every stage agrees
to 1e-9 or better, and the fitted parameters to 1e-6. On a planar ride
(tests/synthetic.make_ride and the golden ride: yaw only, level road) the
Gauss-Newton normal equations are singular in the vertical direction
(J's z columns are rounding noise of 1e-15), so each step's vertical part,
and with it which local minimum a window settles in, follows the rounding:
on the golden ride the reference's own speeds move by up to 0.025 m/s and
its forward axis by up to 0.54 degrees when its inputs move by 1e-15
relative (fit_motion_rounding.py, five draws). There the bars are
on the outcome: speeds within 0.1 m/s (median 0.005), the same RMSE against
the true speed within 0.002 m/s, the forward axis within 5 degrees; the
vertical axis and the steering signal (no solve) still agree to 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from pilotguru_tpu.calib import accelerometer as jacc
from pilotguru_tpu.calib import fit_motion as jfm
from pilotguru_tpu.calib import pieces as jpieces
from pilotguru_tpu.calib import rotation_axis as jrot
from pilotguru_tpu.cli import fit_motion as jcli
from pilotguru_tpu.formats import json_io as jjson
from pilotguru_tpu.geometry import quaternion as jq
from pilotguru_tpu.geometry import strapdown as jstrap
from pilotguru_tpu.timeseries import merge as jmerge
from pilotguru_tpu.timeseries import smoothing as jsmooth
from pilotguru_tpu_torch.calib import accelerometer as tacc
from pilotguru_tpu_torch.calib import fit_motion as tfm
from pilotguru_tpu_torch.calib import pieces as tpieces
from pilotguru_tpu_torch.calib import rotation_axis as trot
from pilotguru_tpu_torch.cli import fit_motion as tcli
from pilotguru_tpu_torch.formats import json_io as tjson
from pilotguru_tpu_torch.geometry import quaternion as tq
from pilotguru_tpu_torch.geometry import strapdown as tstrap
from pilotguru_tpu_torch.timeseries import merge as tmerge
from pilotguru_tpu_torch.timeseries import smoothing as tsmooth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
F64 = torch.float64


def t64(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _random_quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def ride_3d(duration_sec=40.0, imu_hz=50.0, seed=0):
    """A ride with hills: make_ride's yaw and speed profile plus a vertical
    velocity, so the windows' travel has a vertical part and the calibration
    is well conditioned in every direction. Same layout as make_ride's
    arrays: (rot_t, rates, acc_t, accs, gps_t, gps_speeds)."""
    rng = np.random.default_rng(seed)
    t0 = 1_000_000

    def grid(hz, phase):
        n = int(duration_sec * hz)
        t = t0 + phase + (np.arange(n) * (1e6 / hz)).astype(np.int64)
        return np.unique(t + rng.integers(0, max(int(1e5 / hz), 1), n))

    rot_t, acc_t, gps_t = grid(imu_hz, 0), grid(imu_hz, int(0.3e6 / imu_hz)), grid(1.0, 137)

    def sec(t):
        return (t - t0) * 1e-6

    def speed(t):
        return 9.0 + 3.0 * np.sin(2 * np.pi * t / 37.0)

    def climb(t):
        return 1.5 * np.sin(2 * np.pi * t / 17.0)

    def heading(t):
        return 0.6 * np.sin(2 * np.pi * t / 23.0)

    def yaw(t):
        return 0.6 * (2 * np.pi / 23.0) * np.cos(2 * np.pi * t / 23.0)

    rates = np.zeros((rot_t.size, 3))
    rates[:, 2] = yaw(sec(rot_t))
    t = sec(acc_t)
    s, h, w = speed(t), heading(t), yaw(t)
    ds = 3.0 * (2 * np.pi / 37.0) * np.cos(2 * np.pi * t / 37.0)
    ax = ds * np.cos(h) - s * np.sin(h) * w
    ay = ds * np.sin(h) + s * np.cos(h) * w
    az = 1.5 * (2 * np.pi / 17.0) * np.cos(2 * np.pi * t / 17.0) + 9.81
    accs = np.stack([np.cos(h) * ax + np.sin(h) * ay, -np.sin(h) * ax + np.cos(h) * ay, az],
                    axis=-1)
    tg = sec(gps_t)
    return rot_t, rates, acc_t, accs, gps_t, np.hypot(speed(tg), climb(tg))


def _planar_ride(imu_hz, seed):
    r = synthetic.make_ride(duration_sec=40.0, imu_hz=imu_hz, jitter_seed=seed,
                            local_bias=(0.05, -0.1, 0.2))
    return r, (r.rot_times_usec, r.rot_rates, r.acc_times_usec, r.accelerations,
               r.gps_times_usec, r.gps_speeds)


def _windowed(args, batch=15, step=5):
    rot_t, rates, acc_t, accs, gps_t, speeds = args
    ride = jpieces.build_ride_pieces(rot_t, rates, acc_t, accs, gps_t)
    return jpieces.build_windowed_problem(ride, gps_t, speeds, batch, step)


# ---- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 2, 7, 64, 1000])
def test_quat_cumulative_product_matches_associative_scan(length):
    """The log-depth scan against jax.lax.associative_scan, one sequence and
    a batch of them (time on dim -2)."""
    rng = np.random.default_rng(length)
    dqs = _random_quats(rng, (length,))
    want = np.asarray(jq.quat_cumulative_product(jnp.asarray(dqs)))
    got = tq.quat_cumulative_product(t64(dqs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    batch = _random_quats(rng, (3, length))
    want = np.stack([np.asarray(jq.quat_cumulative_product(jnp.asarray(b))) for b in batch])
    np.testing.assert_allclose(tq.quat_cumulative_product(t64(batch)).numpy(), want,
                               rtol=0, atol=1e-13)


def test_quaternion_helpers_match_reference():
    rng = np.random.default_rng(1)
    q1, q2 = _random_quats(rng, (50,)), _random_quats(rng, (50,))
    rates, dt = rng.normal(size=(50, 3)), rng.uniform(0, 0.05, 50)
    rates[3] = 0.0  # the 1e-30 guard
    pairs = [
        (jq.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)), tq.quat_multiply(t64(q1), t64(q2))),
        (jq.quat_conjugate(jnp.asarray(q1)), tq.quat_conjugate(t64(q1))),
        (jq.quat_to_rotation_matrix(jnp.asarray(q1)), tq.quat_to_rotation_matrix(t64(q1))),
        (jq.rotation_rate_to_quat(jnp.asarray(rates), jnp.asarray(dt)),
         tq.rotation_rate_to_quat(t64(rates), t64(dt))),
        (jq.quat_normalize(jnp.asarray(3 * q1)), tq.quat_normalize(t64(3 * q1))),
        (jq.quat_rotate(jnp.asarray(q1), jnp.asarray(rates)), tq.quat_rotate(t64(q1), t64(rates))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)


def test_integrate_motion_matches_reference():
    rng = np.random.default_rng(2)
    n = 300
    rates = rng.normal(scale=0.5, size=(n, 3))
    accs = rng.normal(size=(n, 3)) + [0.0, 0.0, 9.81]
    dt = rng.uniform(0.001, 0.02, n)
    gb, lb, v0 = rng.normal(size=3), rng.normal(scale=0.1, size=3), rng.normal(size=3)
    want = jstrap.integrate_motion(jnp.asarray(rates), jnp.asarray(accs), jnp.asarray(dt),
                                   jnp.asarray(gb), jnp.asarray(lb), jnp.asarray(v0))
    got = tstrap.integrate_motion(t64(rates), t64(accs), t64(dt), t64(gb), t64(lb), t64(v0))
    np.testing.assert_allclose(got.orientations.numpy(), np.asarray(want.orientations),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities),
                               rtol=1e-12, atol=1e-12)
    # Windows along a leading dimension integrate independently.
    batched = tstrap.integrate_motion(t64(np.stack([rates, rates[::-1]])),
                                      t64(np.stack([accs, accs])), t64(np.stack([dt, dt])),
                                      t64(np.stack([gb, gb])), t64(np.stack([lb, lb])),
                                      t64(np.stack([v0, v0])))
    np.testing.assert_array_equal(batched.velocities[0].numpy(), got.velocities.numpy())


# ---- rotation axis and steering ---------------------------------------------------


@pytest.mark.parametrize("imu_hz,seed", [(20.0, 3), (50.0, 0)])
def test_principal_rotation_axes_and_steering_match_reference(imu_hz, seed):
    r, _ = _planar_ride(imu_hz, seed)
    np.testing.assert_array_equal(
        trot.chunk_boundaries(r.rot_times_usec, 500_000),
        jrot.chunk_boundaries(r.rot_times_usec, 500_000))
    want_axes, want_vals = jrot.principal_rotation_axes(r.rot_times_usec, r.rot_rates, 500_000)
    axes, vals = trot.principal_rotation_axes(r.rot_times_usec, r.rot_rates, 500_000,
                                             device="cpu")
    np.testing.assert_allclose(axes.numpy(), np.asarray(want_axes), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=1e-9, atol=1e-15)
    want = jrot.angular_velocities_around_axis(jnp.asarray(r.rot_rates), want_axes[0])
    got = trot.angular_velocities_around_axis(t64(r.rot_rates), axes[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_rotation_axes_refuse_a_short_ride():
    t = np.arange(10, dtype=np.int64) * 100_000
    with pytest.raises(ValueError, match="at least 3 rotation chunks"):
        trot.principal_rotation_axes(t, np.zeros((10, 3)), device="cpu")


# ---- smoothing, merge, pieces ------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.003, 0.05, 2.0])
def test_smooth_time_series_matches_reference(sigma):
    rng = np.random.default_rng(4)
    ts = np.cumsum(rng.uniform(0.0005, 0.004, 800))
    values = rng.normal(size=800)
    targets = np.sort(rng.uniform(ts[0] - 0.01, ts[-1] + 0.01, 300))
    want = np.asarray(jsmooth.smooth_time_series(values, ts, targets, sigma))
    got = tsmooth.smooth_time_series(values, ts, targets, sigma, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    want2 = np.asarray(jsmooth.smooth_time_series(np.stack([values, -values], 1), ts, ts, sigma))
    got2 = tsmooth.smooth_time_series(np.stack([values, -values], 1), ts, ts, sigma,
                                      device="cpu").numpy()
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="sigma must be positive"):
        tsmooth.smooth_time_series(values, ts, targets, 0.0, device="cpu")


@pytest.mark.parametrize("imu_hz,seed", [(20.0, 3), (50.0, 0)])
def test_build_ride_pieces_match_exactly(imu_hz, seed):
    _, args = _planar_ride(imu_hz, seed)
    rot_t, rates, acc_t, accs, gps_t, speeds = args
    want = jpieces.build_ride_pieces(rot_t, rates, acc_t, accs, gps_t)
    got = tpieces.build_ride_pieces(rot_t, rates, acc_t, accs, gps_t)
    for name in ("event_times_usec", "piece_end_usec", "piece_rot_rates",
                 "piece_accelerations", "piece_dt_sec", "piece_gps_end_index",
                 "piece_event_index", "piece_next_event_differs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    wp = jpieces.build_windowed_problem(want, gps_t, speeds, 15, 5)
    gp = tpieces.build_windowed_problem(got, gps_t, speeds, 15, 5)
    for name in ("window_gps_start", "window_gps_len", "piece_lo", "piece_hi", "rot_rates",
                 "accelerations", "dt_sec", "segment_ids", "valid", "event_last",
                 "global_piece_index", "gps_speeds"):
        np.testing.assert_array_equal(getattr(gp, name), getattr(wp, name), err_msg=name)
    lo, hi, starts, pmax = tfm.build_window_index(got, gps_t, 15, 5)
    want_index = jfm.build_window_index(want, gps_t, 15, 5)
    for a, b in zip((lo, hi, starts, pmax), want_index):
        np.testing.assert_array_equal(a, b)


def test_merge_matches_reference_exactly():
    rng = np.random.default_rng(5)
    a = np.unique(rng.integers(0, 10_000, 300))
    b = np.unique(rng.integers(500, 12_000, 200))
    for got, want in zip(tmerge.merge_time_series([a, b]), jmerge.merge_time_series([a, b])):
        np.testing.assert_array_equal(got, want)
    got = tmerge.make_interpolation_pieces(a, b)
    want = jmerge.make_interpolation_pieces(a, b)
    for name in ("reference_end_index", "interpolation_end_index", "start_usec", "end_usec"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    with pytest.raises(ValueError, match="strictly increasing"):
        tmerge.merge_time_series([a[::-1], b])


# ---- the calibration objective and its solve ---------------------------------------


def _problem_tensors(problem):
    return (t64(problem.rot_rates), t64(problem.accelerations), t64(problem.dt_sec),
            t64(problem.segment_ids, torch.int64), t64(problem.gps_speeds))


def test_affine_travel_and_residuals_match_reference():
    problem = _windowed(ride_3d())
    rot, acc, dt, seg, speeds = _problem_tensors(problem)
    a, c, d = tacc.precompute_affine_travel(rot, acc, dt, seg, speeds, problem.num_segments)
    rng = np.random.default_rng(6)
    for w in (0, problem.num_windows // 2, problem.num_windows - 1):
        ja, jc, jd = jacc.precompute_affine_travel(
            jnp.asarray(problem.rot_rates[w]), jnp.asarray(problem.accelerations[w]),
            jnp.asarray(problem.dt_sec[w]), jnp.asarray(problem.segment_ids[w]),
            jnp.asarray(problem.gps_speeds[w]), problem.num_segments)
        np.testing.assert_allclose(a[w].numpy(), np.asarray(ja), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(c[w].numpy(), np.asarray(jc), rtol=1e-12, atol=1e-11)
        np.testing.assert_allclose(d[w].numpy(), np.asarray(jd), rtol=1e-13, atol=0)
        params = rng.normal(scale=[0.1] * 3 + [0.05] * 3 + [3.0] * 3)
        params[2] -= 9.81
        want_r = jacc.window_residuals(jnp.asarray(params), jnp.asarray(problem.rot_rates[w]),
                                       jnp.asarray(problem.accelerations[w]),
                                       jnp.asarray(problem.dt_sec[w]),
                                       jnp.asarray(problem.segment_ids[w]),
                                       jnp.asarray(problem.gps_speeds[w]), problem.num_segments)
        got_r = tacc.window_residuals(t64(params), rot[w], acc[w], dt[w], seg[w], speeds[w],
                                      problem.num_segments)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-11, atol=1e-10)
        # The affine form reproduces the integrated residuals.
        np.testing.assert_allclose(
            tacc.affine_window_residuals(t64(params), a[w], c[w], d[w]).numpy(),
            got_r.numpy(), rtol=1e-10, atol=1e-9)
        want_loss = float(jfm.window_loss_fn(problem, w)(jnp.asarray(params)))
        got_loss = float(tfm.window_loss_fn(problem, w)(params))
        assert got_loss == pytest.approx(want_loss, rel=1e-11)


def test_affine_jacobian_matches_autodiff():
    problem = _windowed(ride_3d())
    rot, acc, dt, seg, speeds = _problem_tensors(problem)
    a, c, d = tacc.precompute_affine_travel(rot[:1], acc[:1], dt[:1], seg[:1], speeds[:1],
                                            problem.num_segments)
    x = t64(np.random.default_rng(7).normal(size=9))
    jac, r = tacc.affine_window_jacobian(x, a[0], c[0], d[0])
    want = torch.func.jacfwd(lambda p: tacc.affine_window_residuals(p, a[0], c[0], d[0]))(x)
    torch.testing.assert_close(jac, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r, tacc.affine_window_residuals(x, a[0], c[0], d[0]))


def test_solve_windows_matches_reference():
    """Parameters and loss of every window, on the ride with hills (each
    window well conditioned)."""
    problem = _windowed(ride_3d())
    want = jacc.solve_windows(problem.rot_rates, problem.accelerations, problem.dt_sec,
                              problem.segment_ids, problem.gps_speeds, problem.num_segments,
                              num_iters=30)
    got = tacc.solve_windows(*_problem_tensors(problem), problem.num_segments, num_iters=30)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=1e-6, atol=1e-10)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert float(got.loss.max()) < 0.01
    g = tacc.gravity_init(*_problem_tensors(problem)[:3])
    want_g = np.stack([np.asarray(jacc.gravity_init(
        jnp.asarray(problem.rot_rates[w]), jnp.asarray(problem.accelerations[w]),
        jnp.asarray(problem.dt_sec[w]), jnp.float64)) for w in range(problem.num_windows)])
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-12, atol=1e-12)


def test_replay_windows_matches_reference():
    problem = _windowed(ride_3d())
    rot, acc, dt, _, _ = _problem_tensors(problem)
    params = np.random.default_rng(8).normal(size=(problem.num_windows, 9))
    want_q, want_v = jacc.replay_windows(params, problem.rot_rates, problem.accelerations,
                                         problem.dt_sec)
    got_q, got_v = tacc.replay_windows(t64(params), rot, acc, dt)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=0, atol=1e-13)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-11, atol=1e-10)


# ---- fit_motion_arrays -----------------------------------------------------------------


def _fit_both(args, batch=15):
    want = jfm.fit_motion_arrays(*args, jfm.FitMotionConfig(
        locations_batch_size=batch, locations_shift_step=5, optimization_iters=30))
    got = tfm.fit_motion_arrays(*args, tfm.FitMotionConfig(
        locations_batch_size=batch, locations_shift_step=5, optimization_iters=30,
        device="cpu"))
    np.testing.assert_array_equal(got.velocity_times_usec, want.velocity_times_usec)
    np.testing.assert_array_equal(got.steering_times_usec, want.steering_times_usec)
    np.testing.assert_allclose(got.vertical_axis, want.vertical_axis, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.steering_angular_velocities,
                               want.steering_angular_velocities, rtol=0, atol=1e-12)
    return got, want


def test_fit_motion_arrays_matches_reference_with_hills():
    got, want = _fit_both(ride_3d())
    np.testing.assert_allclose(got.velocities_m_s, want.velocities_m_s, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.forward_axis, want.forward_axis, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.window_params, want.window_params, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.window_final_loss, want.window_final_loss,
                               rtol=1e-6, atol=1e-10)


def _angle_deg(a, b):
    return np.degrees(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1)))


@pytest.mark.parametrize("imu_hz,seed", [(20.0, 3), (50.0, 0)])
def test_fit_motion_arrays_on_planar_rides(imu_hz, seed):
    """tests/synthetic.make_ride, 40 s (test_calib's sizes): the planar
    bars of the module docstring."""
    r, args = _planar_ride(imu_hz, seed)
    got, want = _fit_both(args)
    diff = np.abs(got.velocities_m_s - want.velocities_m_s)
    assert diff.max() <= 0.1 and np.median(diff) <= 0.005, (diff.max(), np.median(diff))
    truth = r.speed_at(want.velocity_times_usec)
    rmse_got = np.sqrt(np.mean((got.velocities_m_s - truth) ** 2))
    rmse_want = np.sqrt(np.mean((want.velocities_m_s - truth) ** 2))
    assert abs(rmse_got - rmse_want) <= 0.002 and rmse_got < 0.25
    assert _angle_deg(got.forward_axis, want.forward_axis) <= 5.0
    assert got.forward_axis @ np.array([1.0, 0.0, 0.0]) > 0.99
    assert np.max(got.window_final_loss) < 2.0


# ---- formats and the CLI (the slice as a whole) ------------------------------------------


def test_json_writers_are_byte_identical(tmp_path):
    rng = np.random.default_rng(9)
    times = np.cumsum(rng.integers(1, 9999, 20)).astype(np.int64)
    values = rng.normal(size=20) * 1e3
    for pkg, name in ((jjson, "jax"), (tjson, "port")):
        pkg.write_timestamped_values(times, values, str(tmp_path / f"{name}.json"),
                                     "velocities", "speed_m_s")
        pkg.write_forward_axis(values[:3], str(tmp_path / f"{name}_axis.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port_axis.json").read_bytes() == (tmp_path / "jax_axis.json").read_bytes()
    with pytest.raises(ValueError, match="length mismatch"):
        tjson.write_timestamped_values(times, values[:3], str(tmp_path / "x.json"), "a", "b")


def test_json_readers_match_reference():
    ride = os.path.join(GOLDEN, "inputs", "ride")
    for fn, args in (("read_timestamped_3d", ("rotations.json", "rotations")),
                     ("read_timestamped_3d", ("accelerations.json", "accelerations")),
                     ("read_gps_velocities", ("locations.json",))):
        path = os.path.join(ride, args[0])
        for got, want in zip(getattr(tjson, fn)(path, *args[1:]),
                             getattr(jjson, fn)(path, *args[1:])):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def _cli_argv(out_dir):
    ride = os.path.join(GOLDEN, "inputs", "ride")
    return [
        f"--rotations_json={ride}/rotations.json",
        f"--accelerations_json={ride}/accelerations.json",
        f"--locations_json={ride}/locations.json",
        f"--velocities_out_json={out_dir}/velocities.json",
        f"--steering_out_json={out_dir}/steering.json",
        f"--forward_axis_out_json={out_dir}/forward_axis.json",
        "--locations_batch_size=20",
        "--locations_shift_step=5",
    ]


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit_motion_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    try:
        assert tcli.main(_cli_argv(out)) == 0
    finally:
        mp.undo()
    return out


def test_cli_steering_golden_is_byte_identical(cli_outputs):
    name = "steering.json"
    want = os.path.join(GOLDEN, "expected", name)
    assert (cli_outputs / name).read_bytes() == open(want, "rb").read()


def test_cli_velocities_golden(cli_outputs):
    """Same event times; speeds within the planar bars (the golden ride is
    level), and as close to the golden's as the reference's own rounding
    sensitivity allows."""
    got = tjson.read_json(str(cli_outputs / "velocities.json"))["velocities"]
    want = jjson.read_json(os.path.join(GOLDEN, "expected", "velocities.json"))["velocities"]
    assert [e["time_usec"] for e in got] == [e["time_usec"] for e in want]
    diff = np.abs(np.array([e["speed_m_s"] for e in got])
                  - np.array([e["speed_m_s"] for e in want]))
    assert diff.max() <= 0.1 and np.median(diff) <= 0.005, (diff.max(), np.median(diff))


def test_cli_forward_axis_golden(cli_outputs):
    got = tjson.read_json(str(cli_outputs / "forward_axis.json"))["forward_axis"]
    want = jjson.read_json(os.path.join(GOLDEN, "expected", "forward_axis.json"))["forward_axis"]
    assert sorted(got) == ["x", "y", "z"]
    g = np.array([got[k] for k in "xyz"])
    w = np.array([want[k] for k in "xyz"])
    assert abs(np.linalg.norm(g) - 1.0) < 1e-4
    assert _angle_deg(g, w) <= 5.0


def test_cli_matches_the_reference_cli_on_a_ride_with_hills(tmp_path):
    """Both CLIs on the same JSON files of the ride with hills: the outputs
    agree to 1e-8."""
    rot_t, rates, acc_t, accs, gps_t, speeds = ride_3d(duration_sec=30.0)
    inputs = tmp_path / "in"
    inputs.mkdir()
    for name, key, t, v in (("rotations", "rotations", rot_t, rates),
                            ("accelerations", "accelerations", acc_t, accs)):
        tjson.write_json({key: [{"time_usec": int(a), "x": b[0], "y": b[1], "z": b[2]}
                                for a, b in zip(t, v.tolist())]}, str(inputs / f"{name}.json"))
    tjson.write_json({"locations": [{"time_usec": int(a), "speed_m_s": b}
                                    for a, b in zip(gps_t, speeds.tolist())]},
                     str(inputs / "locations.json"))
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / name
        out.mkdir()
        argv = [f"--rotations_json={inputs}/rotations.json",
                f"--accelerations_json={inputs}/accelerations.json",
                f"--locations_json={inputs}/locations.json",
                f"--velocities_out_json={out}/v.json", f"--steering_out_json={out}/s.json",
                f"--forward_axis_out_json={out}/f.json", "--locations_batch_size=15",
                "--dtype=float64"]
        mp = pytest.MonkeyPatch()
        mp.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
        try:
            assert cli.main(argv) == 0
        finally:
            mp.undo()
        outs[name] = out
    for f, root, key in (("v.json", "velocities", "speed_m_s"),
                         ("s.json", "steering", "angular_velocity")):
        got = tjson.read_json(str(outs["port"] / f))[root]
        want = tjson.read_json(str(outs["jax"] / f))[root]
        assert [e["time_usec"] for e in got] == [e["time_usec"] for e in want]
        np.testing.assert_allclose([e[key] for e in got], [e[key] for e in want],
                                   rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        list(tjson.read_json(str(outs["port"] / "f.json"))["forward_axis"].values()),
        list(tjson.read_json(str(outs["jax"] / "f.json"))["forward_axis"].values()),
        rtol=0, atol=1e-8)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Unset, the platform is cuda: without a card the CLI raises instead of
    falling back to the CPU. The library entry defaults to the card too."""
    assert tfm.FitMotionConfig().device == "cuda"
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("PILOTGURU_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_cli_argv(tmp_path))


def test_cli_refuses_bad_flags(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tcli.main(_cli_argv(tmp_path) + ["--optimization_iters=0"])
    with pytest.raises(SystemExit):
        tcli.main(_cli_argv(tmp_path) + ["--locations_batch_size=3"])

