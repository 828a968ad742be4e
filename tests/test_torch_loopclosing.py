"""Loop closing of the port (vo/sim3.py, vo/posegraph.py, vo/loopclosing.py
and the tracker's closure path) against the JAX package, in float64 on the
CPU: Sim(3) algebra and Umeyama (1e-10), RANSAC with the reference's draws
replayed (same inliers), the pose graph on a chain with a loop edge and
padded edges (1e-6), the vote counts (equal integers); then the port's
tracker on the reference's synthetic loop ride (tests/test_loopclosing.py
LoopScene, seam BA) and on its open road (test_vo_tracking SyntheticScene).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_loopclosing import LoopScene
from test_vo_tracking import SyntheticScene

from pilotguru_tpu.vo import loopclosing as jloop
from pilotguru_tpu.vo import posegraph as jposegraph
from pilotguru_tpu.vo import sim3 as jsim3
from pilotguru_tpu_torch.vo import loopclosing, posegraph, sim3
from pilotguru_tpu_torch.vo.tracking import (
    LOST,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def _random_sim7(rng, n=()):
    size = n + (1,)
    return np.concatenate([rng.normal(size=n + (3,)) * 0.5, rng.normal(size=n + (3,)),
                           rng.uniform(-0.4, 0.4, size=size)], axis=-1)


def test_sim3_algebra_matches_reference():
    rng = np.random.default_rng(0)
    a, b = _random_sim7(rng), _random_sim7(rng)
    x = rng.normal(size=(9, 3))
    for got, want in [
        (sim3.compose(t(a), t(b)), jsim3.compose(jnp.asarray(a), jnp.asarray(b))),
        (sim3.inverse(t(a)), jsim3.inverse(jnp.asarray(a))),
        (sim3.error_vector(t(a), t(b)), jsim3.error_vector(jnp.asarray(a), jnp.asarray(b))),
        (sim3.act(t(a), t(x)), jsim3.act(jnp.asarray(a), jnp.asarray(x))),
        (sim3.to_pose6(t(a)), jsim3.to_pose6(jnp.asarray(a))),
        (sim3.from_pose6(t(a[:6])), jsim3.from_pose6(jnp.asarray(a[:6]))),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=0)
    # Batched forms equal the reference's vmap.
    batch_a, batch_b = _random_sim7(rng, (5,)), _random_sim7(rng, (5,))
    want = jax.vmap(jsim3.compose)(jnp.asarray(batch_a), jnp.asarray(batch_b))
    np.testing.assert_allclose(sim3.compose(t(batch_a), t(batch_b)).numpy(),
                               np.asarray(want), atol=1e-10, rtol=0)


def test_umeyama_matches_reference():
    rng = np.random.default_rng(1)
    truth = _random_sim7(rng)
    pa = rng.normal(size=(40, 3))
    pb = np.asarray(jsim3.act(jnp.asarray(truth), jnp.asarray(pa))) + rng.normal(0, 1e-3, (40, 3))
    w = rng.uniform(0.2, 1.0, 40)
    got = sim3.umeyama_sim3(t(pa), t(pb), t(w))
    want = jsim3.umeyama_sim3(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w))
    np.testing.assert_allclose(got.sim7.numpy(), np.asarray(want.sim7), atol=1e-10, rtol=0)
    assert bool(got.valid) and bool(want.valid)
    np.testing.assert_allclose(got.sim7.numpy(), truth, atol=2e-3)
    # Collinear sources are degenerate on both sides.
    line = np.outer(np.linspace(-1, 1, 10), [1.0, 2.0, -0.5])
    assert not bool(sim3.umeyama_sim3(t(line), t(line), t(np.ones(10))).valid)
    assert not bool(jsim3.umeyama_sim3(jnp.asarray(line), jnp.asarray(line),
                                       jnp.ones(10)).valid)


def test_ransac_umeyama_with_replayed_draws():
    rng = np.random.default_rng(2)
    n, real = 128, 100
    truth = _random_sim7(rng)
    pa = np.zeros((n, 3))
    pa[:real] = rng.normal(size=(real, 3)) * 2.0
    pb = np.zeros((n, 3))
    pb[:real] = np.asarray(jsim3.act(jnp.asarray(truth), jnp.asarray(pa[:real])))
    pb[:real] += rng.normal(0, 1e-3, (real, 3))
    pb[:25] += rng.normal(0, 1.0, (25, 3))  # outliers
    valid = np.arange(n) < real
    key = jax.random.PRNGKey(3)
    w = jnp.asarray(valid).astype(jnp.float64)
    p = w / jnp.sum(w)
    samples = np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(3,), replace=False, p=p)
    )(jax.random.split(key, 64)))
    want = jsim3.ransac_umeyama(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key)
    got = sim3.ransac_umeyama(t(pa), t(pb), t(valid), samples=t(samples))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) >= 70
    np.testing.assert_allclose(got.sim7.numpy(), np.asarray(want.sim7), atol=1e-10, rtol=0)
    # Drawn from the port's own generator, the fit finds the same inliers.
    own = sim3.ransac_umeyama(t(pa), t(pb), t(valid), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(own.inliers.numpy(), np.asarray(want.inliers))


def test_pose_graph_matches_reference():
    """A 20-node chain whose last node drifted, one loop edge (19 -> 0) and
    12 padded edges (invalid, so inert)."""
    rng = np.random.default_rng(4)
    k = 20
    nodes = _random_sim7(rng, (k,)) * 0.3
    nodes[0] = 0.0
    edge_i, edge_j, meas = jposegraph.chain_edges(jnp.asarray(nodes))
    drifted = nodes.copy()
    drifted[10:] += rng.normal(0, 0.02, (10, 7))
    loop = np.asarray(jsim3.compose(jnp.asarray(nodes[0]), jsim3.inverse(jnp.asarray(nodes[-1]))))
    pad = 12
    ei = np.concatenate([np.asarray(edge_i), [0], np.zeros(pad, np.int32)]).astype(np.int32)
    ej = np.concatenate([np.asarray(edge_j), [k - 1], np.zeros(pad, np.int32)]).astype(np.int32)
    me = np.concatenate([np.asarray(meas), loop[None], np.zeros((pad, 7))])  # identity
    ok = np.arange(ei.size) < k
    want = jposegraph.optimize_pose_graph(jnp.asarray(drifted), jnp.asarray(ei), jnp.asarray(ej),
                                          jnp.asarray(me), jnp.asarray(ok))
    got = posegraph.optimize_pose_graph(t(drifted), t(ei), t(ej), t(me), t(ok))
    np.testing.assert_allclose(got.nodes7.numpy(), np.asarray(want.nodes7), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got.final_loss), float(want.final_loss), rtol=1e-6,
                               atol=1e-12)
    # The port's chain edges equal the reference's.
    gi, gj, gm = posegraph.chain_edges(t(nodes))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(edge_i))
    np.testing.assert_allclose(gm.numpy(), np.asarray(meas), atol=1e-10, rtol=0)


def _refine_inputs(dtype):
    rng = np.random.default_rng(6)
    p = 40
    m_true = np.r_[rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.2, 0.1]
    cand_pose = np.r_[rng.normal(size=3) * 0.1, rng.normal(size=3)]
    cur_pose = np.r_[rng.normal(size=3) * 0.1, rng.normal(size=3)]
    pts_cand = rng.normal(size=(p, 3)) + [0.0, 0.0, 6.0]
    pts_cur = rng.normal(size=(p, 3)) + [0.0, 0.0, 6.0]

    def cam(pose, pts):
        return np.asarray(jsim3.act(jnp.asarray(np.r_[pose, 0.0]), jnp.asarray(pts)))

    in_cur = np.asarray(jsim3.act(jsim3.inverse(jnp.asarray(m_true)),
                                  jnp.asarray(cam(cand_pose, pts_cand))))
    in_cand = np.asarray(jsim3.act(jnp.asarray(m_true), jnp.asarray(cam(cur_pose, pts_cur))))
    obs_cur = in_cur[:, :2] / in_cur[:, 2:] + rng.normal(0, 1e-3, (p, 2))
    obs_cand = in_cand[:, :2] / in_cand[:, 2:] + rng.normal(0, 1e-3, (p, 2))
    m0 = m_true + rng.normal(0, 0.01, 7)
    valid = np.arange(p) < p - 4
    args = (m0, cand_pose, cur_pose, pts_cand, obs_cur, pts_cur, obs_cand)
    return [np.asarray(a, dtype) for a in args] + [valid]


def test_refine_sim3_matches_reference():
    args = _refine_inputs(np.float64)
    want = jloop.refine_sim3(*map(jnp.asarray, args))
    got = loopclosing.refine_sim3(*map(t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-8, rtol=0)
    # The card's float32 path runs the same forward-mode Jacobians.
    got32 = loopclosing.refine_sim3(*map(t, _refine_inputs(np.float32)))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_vote_counts_match_reference():
    rng = np.random.default_rng(5)
    k, n = 300, 6
    cur = rng.integers(0, 2, (k, 256)).astype(np.uint8)
    cur_valid = rng.random(k) > 0.1
    stack = rng.integers(0, 2, (n, k, 256)).astype(np.uint8)
    for i in range(n):  # keyframe i shares 40 * i noisy descriptors
        shared = rng.choice(k, 40 * i, replace=False)
        noisy = cur[shared].copy()
        noisy[:, :8] ^= 1
        stack[i, shared] = noisy
    stack_valid = rng.random((n, k)) > 0.1
    want = np.asarray(jloop._vote_counts(jnp.asarray(cur), jnp.asarray(cur_valid),
                                         jnp.asarray(stack), jnp.asarray(stack_valid)))
    got = loopclosing._vote_counts(t(cur), t(cur_valid), t(stack), t(stack_valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[-1] > 150 and want[0] == 0


# ------------------------------------------------------------------ tracker
def _drive(scene, features_of, steps, dtype=torch.float64, **config):
    tracker = MonocularTracker(
        CameraModel(fx=1.0, fy=1.0, cx=0.0, cy=0.0),
        TrackerConfig(total_budget=scene.budget, min_init_matches=40, min_init_inliers=30,
                      min_track_inliers=15, match_search_radius=0.1, **config),
        device="cpu", dtype=dtype,
    )
    zeros_level = np.zeros(scene.budget, np.int32)
    zeros_angle = np.zeros(scene.budget, np.float32)
    states = []
    for i, step in enumerate(steps):
        kp, desc, valid = features_of(step)[:3]
        states.append(tracker.process_features(kp, desc, valid, i, int(i * 33333),
                                               zeros_level, zeros_angle))
    tracker.finalize()
    return tracker, states


def _closure_error(tracker):
    """End-to-start camera-centre distance over the trajectory's extent (as
    tests/test_loopclosing.py::closure_error)."""
    centres = np.stack([fp.camera_center() for fp in tracker.final_trajectory()
                        if not fp.is_lost])
    extent = np.max(np.linalg.norm(centres - centres.mean(axis=0), axis=1))
    return np.linalg.norm(centres[-1] - centres[0]) / max(extent, 1e-9)


@pytest.fixture(scope="module")
def loop_runs():
    runs = {}
    for on in (False, True):
        scene = LoopScene(seed=0)
        runs[on] = _drive(scene, scene.frame_features, np.linspace(0, 2 * np.pi, 90),
                          keyframe_max_gap=4, enable_loop_closing=on,
                          loop_min_match_count=40, loop_min_inliers=15, loop_ba="seam")
    return runs


def test_loop_ride_closes_and_cuts_drift(loop_runs):
    """Measured: 1 closure; closure error 0.00132 with loop closing against
    0.0358 without (27x)."""
    (off, states_off), (on, states_on) = loop_runs[False], loop_runs[True]
    assert LOST not in states_off and LOST not in states_on
    assert off.stats["loop_closures"] == 0
    assert on.stats["loop_closures"] >= 1
    assert _closure_error(on) < _closure_error(off) / 5.0


def test_loop_ride_closes_in_float32_with_global_ba(loop_runs):
    """The card's configuration: float32 geometry, global BA after the
    closure. Measured: 1 closure, closure error 0.00123."""
    scene = LoopScene(seed=0)
    tracker, states = _drive(scene, scene.frame_features, np.linspace(0, 2 * np.pi, 90),
                             dtype=torch.float32, keyframe_max_gap=4,
                             loop_min_match_count=40, loop_min_inliers=15, loop_ba="global")
    assert LOST not in states
    assert tracker.stats["loop_closures"] >= 1
    assert _closure_error(tracker) < _closure_error(loop_runs[False][0]) / 5.0


def test_open_road_closes_no_loop():
    scene = SyntheticScene()
    tracker, states = _drive(scene, scene.frame_features, np.arange(0, 12.0, 0.25),
                             loop_exclude_recent=5, loop_cooldown_keyframes=2)
    assert LOST not in states
    assert tracker.stats["loop_closures"] == 0
