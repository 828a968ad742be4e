"""The port's ORB extractor (pilotguru_tpu_torch/vo/features.py) against the
JAX package's, stage by stage and end to end on frames of the golden video.

The JAX extractor runs its TPU path: the Pallas FAST+NMS kernel in
interpret mode (PGTPU_FAST_IMPL=pallas), and for the fused configuration
also the Pallas blur + patch-gather kernel (PGTPU_PATCH_IMPL=fused). Both
switches are read while the jitted extractor traces, so each fixture jits
it afresh: no cached program of another configuration is reused. Inputs
are float32 images from numpy or the video.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.ml.augmentation import gaussian_blur as jax_gaussian_blur
from pilotguru_tpu.vo import features as jf
from pilotguru_tpu_torch.vo import features as tf
from pilotguru_tpu_torch.vo.pipeline import video_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = os.path.join(REPO, "tests", "golden", "inputs", "video.mp4")


@pytest.fixture(scope="module")
def golden_frames():
    frames = {}
    for f in video_frames(VIDEO):
        if f.frame_id in (0, 60):
            frames[f.frame_id] = f.gray.astype(np.float32) / 255.0
    return frames


def _fresh_jax_extractor(**switches):
    """The reference extractor jitted afresh, traced while the environment
    holds ``switches`` (PGTPU_* names). JAX caches traces by function
    object, so the jitted function is a new one each time."""

    def extract(image, num_levels, total_budget):
        return jf.extract_orb_features.__wrapped__(
            image, num_levels=num_levels, total_budget=total_budget
        )

    fn = jax.jit(extract, static_argnames=("num_levels", "total_budget"))
    mp = pytest.MonkeyPatch()
    for name, value in switches.items():
        mp.setenv(name, value)
    return fn, mp


@pytest.fixture(scope="module")
def jax_extract_pallas():
    """The reference extractor on its TPU path (Pallas FAST+NMS, interpret
    mode on the CPU)."""
    fn, mp = _fresh_jax_extractor(PGTPU_FAST_IMPL="pallas")
    yield fn
    mp.undo()


@pytest.fixture(scope="module")
def jax_extract_fused():
    """The reference extractor on its fused TPU path: Pallas FAST+NMS and
    the Pallas blur + patch gather, both in interpret mode."""
    fn, mp = _fresh_jax_extractor(PGTPU_FAST_IMPL="pallas", PGTPU_PATCH_IMPL="fused")
    yield fn
    mp.undo()


def test_constant_tables_byte_equal():
    assert tf.FAST_CIRCLE.tobytes() == jf.FAST_CIRCLE.tobytes()
    assert tf.BRIEF_PATTERN.tobytes() == jf.BRIEF_PATTERN.tobytes()
    assert tf._BRIEF_BIN_MATRIX.tobytes() == jf._BRIEF_BIN_MATRIX.tobytes()
    assert tf._ORIENT_WX.tobytes() == jf._ORIENT_WX.tobytes()
    assert tf._ORIENT_WY.tobytes() == jf._ORIENT_WY.tobytes()
    assert tf.BRIEF_ANGLE_BINS == jf.BRIEF_ANGLE_BINS
    assert tf.PATCH_GATHER_RADIUS == jf.PATCH_GATHER_RADIUS


def test_brief_taps_reproduce_bin_matrix():
    """The gathered taps are the bin matrix's two non-zeros per column, so
    q[tap1] - q[tap2] equals the reference's q @ D for every column."""
    rebuilt = np.zeros(jf._BRIEF_BIN_MATRIX.shape, np.int32)
    cols = np.arange(rebuilt.shape[1])
    tap1 = tf._BRIEF_TAP1.reshape(-1)
    tap2 = tf._BRIEF_TAP2.reshape(-1)
    np.add.at(rebuilt, (tap1, cols), 1)
    np.add.at(rebuilt, (tap2, cols), -1)
    np.testing.assert_array_equal(rebuilt, jf._BRIEF_BIN_MATRIX.astype(np.int32))
    tables = tf.tables_as_tensors("cpu")
    assert tables.brief_tap1.numpy().tobytes() == tf._BRIEF_TAP1.astype(np.int64).tobytes()
    assert tables.orient_wx.numpy().tobytes() == jf._ORIENT_WX.reshape(-1).tobytes()


def test_resize_every_level_within_1e6(golden_frames):
    img = golden_frames[0]
    h, w = img.shape
    worst = 0.0
    for level, (lh, lw) in enumerate(tf.level_shapes(h, w, 8, 1.2)):
        if level == 0:
            continue
        want = np.asarray(jax.image.resize(jnp.asarray(img), (lh, lw), method="linear"))
        got = tf.resize_linear(torch.from_numpy(img), lh, lw).numpy()
        assert got.shape == want.shape == (lh, lw)
        worst = max(worst, float(np.abs(got - want).max()))
    # Measured 1.19e-7 (one float32 ulp at 1.0: another summation order).
    assert worst <= 1e-6


def test_blur_within_1e6(golden_frames):
    img = golden_frames[60]
    want = np.asarray(jax_gaussian_blur(jnp.asarray(img)[None, :, :, None], 2.0)[0, :, :, 0])
    got = tf.gaussian_blur(torch.from_numpy(img)).numpy()
    # Measured 1.19e-7.
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_select_grid_topk_ties():
    """Ties on purpose: many all-zero cells, equal cell maxima across cells,
    and repeated maxima inside a cell. The port must pick the first maximum
    in a cell and order equal cells by index, as argmax and lax.top_k do."""
    rng = np.random.default_rng(3)
    scores = np.zeros((70, 100), np.float32)
    scores[5, 7] = scores[5, 9] = scores[12, 3] = 0.5  # repeats in one cell
    for _ in range(12):  # equal maxima in many cells
        scores[rng.integers(16, 64), rng.integers(0, 96)] = 0.25
    scores[40:48, 50:60] = rng.choice([0.1, 0.3], size=(8, 10)).astype(np.float32)
    for budget in (3, 10, 24, 40):
        yx, resp, valid = tf.select_grid_topk(torch.from_numpy(scores), budget)
        wyx, wresp, wvalid = jf.select_grid_topk(jnp.asarray(scores), budget)
        np.testing.assert_array_equal(yx.numpy(), np.asarray(wyx))
        np.testing.assert_array_equal(resp.numpy(), np.asarray(wresp))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))


def _integer_keypoints_jax(img, num_levels, budgets):
    out = []
    h, w = img.shape
    for level, (lh, lw) in enumerate(tf.level_shapes(h, w, num_levels, 1.2)):
        lvl = jnp.asarray(img) if level == 0 else jax.image.resize(
            jnp.asarray(img), (lh, lw), method="linear")
        from pilotguru_tpu.vo.fast_pallas import fast_nms_pallas

        _, nms = fast_nms_pallas(lvl, 20.0 / 255.0, interpret=True)
        out.append(np.asarray(jf.select_grid_topk(nms, budgets[level])[0]))
    return out


def _integer_keypoints_port(img, num_levels, budgets):
    out = []
    h, w = img.shape
    t = torch.from_numpy(img)
    for level, (lh, lw) in enumerate(tf.level_shapes(h, w, num_levels, 1.2)):
        lvl = t if level == 0 else tf.resize_linear(t, lh, lw)
        _, nms = tf.fast_nms(lvl, 20.0 / 255.0)
        out.append(tf.select_grid_topk(nms, budgets[level])[0].numpy())
    return out


def _check_extractor(img, want, patch_impl):
    """600 features over 3 levels (the golden camera's ORB settings)."""
    got = tf.extract_orb_features(torch.from_numpy(img), num_levels=3, total_budget=600,
                                  patch_impl=patch_impl)
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}

    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["level"], want["level"])
    valid = want["valid"]
    assert valid.sum() > 300

    budgets = tf.pyramid_level_budgets(600, 3, 1.2)
    for a, b in zip(_integer_keypoints_port(img, 3, budgets),
                    _integer_keypoints_jax(img, 3, budgets)):
        np.testing.assert_array_equal(a, b)

    # xy: level 0 is exact (measured 0). Coarser levels inherit the resize's
    # one-ulp differences (another summation order) through the sub-pixel
    # parabola; the level scale (1.2**level) carries them into the level-0
    # coordinate. The bar is in float32 ulps of the coordinate: at most 2
    # at levels > 0. Measured: 2 ulps at most (3.05e-5 px at y = 153.85 on
    # level 1 of frame 60; an ulp there is 1.53e-5).
    err = np.abs(got["xy"] - want["xy"])
    ulps = np.spacing(np.maximum(np.abs(got["xy"]), np.abs(want["xy"])).astype(np.float32))
    coarse = valid & (want["level"] > 0)
    assert (err[coarse] <= 2 * ulps[coarse]).all(), float((err / ulps)[coarse].max())
    assert err[valid & (want["level"] == 0)].max() == 0.0

    # Descriptors: exact for >= 99.5% of valid keypoints; a miss is allowed
    # only for an angle within 1e-4 rad of a steering-bin boundary.
    same = (got["descriptors"] == want["descriptors"]).all(axis=1)
    assert same[valid].mean() >= 0.995
    step = 2 * np.pi / tf.BRIEF_ANGLE_BINS
    edge_dist = np.abs((want["angle"] / step) % 1.0 - 0.5) * step
    assert (edge_dist[valid & ~same] < 1e-4).all()
    np.testing.assert_allclose(got["angle"][valid], want["angle"][valid], atol=1e-4)


@pytest.mark.parametrize("frame_id", [0, 60])
def test_extractor_matches_reference(golden_frames, jax_extract_pallas, frame_id):
    """Blur then gather (K2). Measured: descriptors 100% equal on both
    frames, angles within 3.3e-5 rad."""
    img = golden_frames[frame_id]
    want = jax_extract_pallas(jnp.asarray(img), num_levels=3, total_budget=600)
    _check_extractor(img, want, "blur_then_gather")


@pytest.mark.parametrize("frame_id", [0, 60])
def test_fused_extractor_matches_reference(golden_frames, jax_extract_fused, frame_id):
    """The fused blur + gather (K3) against the reference's fused path.
    Measured: descriptors 100% equal on both frames, angles within 2.1e-5
    rad, xy within 2 ulps."""
    img = golden_frames[frame_id]
    want = jax_extract_fused(jnp.asarray(img), num_levels=3, total_budget=600)
    _check_extractor(img, want, "fused")
