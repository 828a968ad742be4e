"""The port's dataset loading, batching and sample weighters
(pilotguru_tpu_torch.ml.data, ml.weighting: own copies of the JAX
package's numpy modules) against the JAX package's on the same inputs:
equal arrays, index batches and weights."""

import numpy as np
import pytest

from pilotguru_tpu.ml import data as jax_data
from pilotguru_tpu.ml import weighting as jax_weighting
from pilotguru_tpu_torch.ml import data, weighting


@pytest.mark.parametrize("history", [False, True])
def test_load_dataset(tmp_path, history):
    rng = np.random.default_rng(0)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        for i in range(3):
            shape = (2, 3, 6, 5) if history else (3, 6, 5)
            np.savez(tmp_path / d / f"frame-{i:06d}-data.npz",
                     frame_img=rng.integers(0, 256, shape, dtype=np.uint8),
                     steering=rng.normal(size=(2,)).astype(np.float32),
                     forward_axis=rng.normal(size=(3,)).astype(np.float32))
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    names = ["frame_img", "steering", "forward_axis"]
    want = jax_data.load_dataset(dirs, names)
    got = data.load_dataset(dirs, names)
    for name in names:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert got["frame_img"].shape == ((6, 6, 5, 6) if history else (6, 6, 5, 3))
    with pytest.raises(ValueError):
        data.load_dataset([str(tmp_path / "a")], names, "nothing.npz")


def test_batches_names_and_images():
    for n, size in ((10, 3), (9, 3), (1, 4)):
        want = list(jax_data.batches(n, size, np.random.default_rng(5)))
        got = list(data.batches(n, size, np.random.default_rng(5)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.concatenate(list(data.batches(n, size, None))),
                                      np.arange(n))
    assert data.model_file_name("d", 2, data.BEST) == jax_data.model_file_name("d", 2, "best")
    assert data.model_file_name("d", 2, data.BEST).endswith("model-2-best.msgpack")
    assert data.preload_model_names("m", 2) == jax_data.preload_model_names("m", 2)
    assert data.preload_model_names(None, 2) is None
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(data.images_to_float(u8), jax_data.images_to_float(u8))
    with pytest.raises(ValueError):
        data.images_to_float(u8.astype(np.float32))


@pytest.mark.parametrize("options", [
    {"name": "uniform"},
    {"name": "label_l1", "label_l1_weight_scale": 2.5},
    {"name": "exp_recent_loss", "recent_loss_lr": 0.3, "recent_loss_exp_scale": 4.0,
     "raw_weight_clip": 3.0},
])
def test_weighters_over_register_and_step_sequences(options):
    rng = np.random.default_rng(1)
    labels = rng.normal(0, 1, 50)
    want = jax_weighting.make_sample_weighter(options, labels)
    got = weighting.make_sample_weighter(options, labels)
    for _ in range(4):
        for _ in range(3):
            idx = rng.choice(50, 16, replace=False)
            np.testing.assert_array_equal(got.get_weights(idx), want.get_weights(idx))
            losses = rng.uniform(0, 0.5, 16)
            want.register_losses(idx, losses)
            got.register_losses(idx, losses)
        want.step()
        got.step()
        np.testing.assert_array_equal(got.get_weights(np.arange(50)),
                                      want.get_weights(np.arange(50)))
    with pytest.raises(ValueError):
        weighting.make_sample_weighter({"name": "nope"}, labels)
