"""The port's batch augmentation (pilotguru_tpu_torch.ml.augmentation)
against the JAX package's, each augmenter and the whole chain, with the JAX
package's own draws (augment_batch's 5-way key split) handed to the port.
Crops, grayscale and the draws' use are exact up to float32 rounding of
the same sums; the blur sums its taps in another order (1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.ml import augmentation as jax_aug
from pilotguru_tpu_torch.ml import augmentation as aug

torch.set_num_threads(2)


def _images(seed, b=5, h=18, w=60, c=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, h, w, c)).astype(np.float32),
            rng.normal(0, 1, (b, 2)).astype(np.float32))


def _jax_draws(key, b, settings):
    """The draws jax_aug.augment_batch makes from ``key``."""
    k_shift, k_pca, _, k_blur_p, k_gray = jax.random.split(key, 5)
    mags = None
    if settings.random_shift_directions is not None:
        d = settings.random_shift_directions.shape[0]
        mags = torch.as_tensor(np.asarray(jax.random.normal(k_pca, (b, d), jnp.float32)))
    return aug.AugmentDraws(
        torch.as_tensor(np.asarray(jax.random.uniform(k_shift, (b,), minval=-1.0, maxval=1.0))),
        mags,
        torch.as_tensor(np.asarray(jax.random.uniform(k_blur_p, (b,)) < settings.blur_prob)),
        torch.as_tensor(np.asarray(jax.random.uniform(k_gray, (b,))
                                   < settings.grayscale_interpolate_prob)))


def test_center_crop_width():
    images, _ = _images(0)
    want = np.asarray(jax_aug.center_crop_width(jnp.asarray(images), 41))
    np.testing.assert_array_equal(aug.center_crop_width(torch.as_tensor(images), 41).numpy(), want)


@pytest.mark.parametrize("max_shift", [7, 14])  # 14 is past the margin of 10: clamped
def test_random_shifted_crop(max_shift):
    images, labels = _images(1)
    key = jax.random.PRNGKey(max_shift)
    want_img, want_lab = jax_aug.random_shifted_crop(key, jnp.asarray(images), jnp.asarray(labels),
                                                     40, max_shift, jnp.asarray([0.5, -2.0]))
    fraction = torch.as_tensor(np.asarray(jax.random.uniform(key, (5,), minval=-1.0, maxval=1.0)))
    got_img, got_lab = aug.random_shifted_crop(torch.as_tensor(images), torch.as_tensor(labels),
                                               40, max_shift, (0.5, -2.0), fraction)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), rtol=0, atol=1e-6)


def test_random_pca_shift_and_directions():
    images, _ = _images(2)
    directions = jax_aug.pca_rgb_directions(images)
    np.testing.assert_array_equal(aug.pca_rgb_directions(images), directions)
    key = jax.random.PRNGKey(3)
    want = jax_aug.random_pca_shift(key, jnp.asarray(images), directions)
    mags = torch.as_tensor(np.asarray(jax.random.normal(key, (5, 3), jnp.float32)))
    got = aug.random_pca_shift(torch.as_tensor(images), directions, mags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.6, 2.0])
def test_gaussian_blur(sigma):
    images, _ = _images(4)
    want = np.asarray(jax_aug.gaussian_blur(jnp.asarray(images), sigma))
    got = aug.gaussian_blur(torch.as_tensor(images), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_grayscale():
    images, _ = _images(5)
    want = np.asarray(jax_aug.grayscale(jnp.asarray(images)))
    np.testing.assert_allclose(aug.grayscale(torch.as_tensor(images)).numpy(), want,
                               rtol=0, atol=2e-7)


def test_the_whole_chain_with_the_jax_draws():
    images, labels = _images(6, b=8)
    directions = jax_aug.pca_rgb_directions(images)
    kw = dict(target_width=40, max_horizontal_shift_pixels=9,
              horizontal_label_shift_rate=(0.3, -0.1), blur_sigma=1.5, blur_prob=0.5,
              grayscale_interpolate_prob=0.5, random_shift_directions=directions)
    key = jax.random.PRNGKey(7)
    want_img, want_lab = jax_aug.augment_batch(key, jnp.asarray(images), jnp.asarray(labels),
                                               jax_aug.AugmentSettings(**kw))
    settings = aug.AugmentSettings(**kw)
    draws = _jax_draws(key, 8, settings)
    assert 0 < int(draws.blur.sum()) < 8 and 0 < int(draws.grayscale.sum()) < 8
    got_img, got_lab = aug.augment_batch(torch.as_tensor(images), torch.as_tensor(labels),
                                         settings, draws)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_lab.numpy(), np.asarray(want_lab), rtol=0, atol=1e-6)


def test_draws_follow_the_settings():
    settings = aug.AugmentSettings(target_width=40, max_horizontal_shift_pixels=5,
                                   blur_prob=0.25, grayscale_interpolate_prob=0.75,
                                   random_shift_directions=np.eye(3, dtype=np.float32))
    draws = aug.draw_augmentation(torch.Generator().manual_seed(0), 4096, settings, "cpu")
    assert draws.shift_fraction.shape == (4096,)
    assert -1 <= float(draws.shift_fraction.min()) and float(draws.shift_fraction.max()) < 1
    assert draws.pca_magnitudes.shape == (4096, 3)
    assert abs(float(draws.blur.float().mean()) - 0.25) < 0.03
    assert abs(float(draws.grayscale.float().mean()) - 0.75) < 0.03
    again = aug.draw_augmentation(torch.Generator().manual_seed(0), 4096, settings, "cpu")
    assert torch.equal(again.shift_fraction, draws.shift_fraction)
    off = aug.draw_augmentation(torch.Generator().manual_seed(0), 4, aug.AugmentSettings(), "cpu")
    assert off == aug.AugmentDraws(None, None, None, None)
