"""Checkpoints across the two packages: the port's msgpack codec
(pilotguru_tpu_torch/utils/msgpack.py) against flax.serialization, and
ml/training.py's save_net / load_net / load_ensemble_params against the JAX
package's. Exact: arrays equal, files byte-identical."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu.ml import training as jax_training
from pilotguru_tpu_torch.ml import convert, models, training
from pilotguru_tpu_torch.utils import msgpack

torch.set_num_threads(2)

BIAS = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
OPTIONS = {models.NET_NAME: models.NVIDIA_NET_NAME, models.NET_HEAD_DIMS: 10,
           models.LABEL_DIMENSIONS: 1, models.DROPOUT_PROB: 0.0,
           models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS}
SHAPE = (66, 200, 3)


def _flax_variables(seed):
    model = jax_models.make_network(OPTIONS, BIAS)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed)},
        {models.FRAME_IMG: jnp.zeros((1,) + SHAPE), models.FORWARD_AXIS: jnp.zeros((1, 3))},
        train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), variables["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


def _assert_trees_equal(a, b):
    leaves_a = jax.tree_util.tree_leaves_with_path(a)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(leaves_a) == len(leaves_b)
    for path, value in leaves_a:
        assert np.asarray(value).dtype == np.asarray(leaves_b[path]).dtype
        np.testing.assert_array_equal(np.asarray(value), np.asarray(leaves_b[path]))


@pytest.mark.parametrize("tree", [
    {"a": 1, "b": -3, "c": 2 ** 40, "d": -(2 ** 40), "e": 1.5, "f": "text", "g": True,
     "h": None, "i": [1, 2.5, "x"], "j": b"raw"},
    {"x" * 40: list(range(20)), "n": {str(k): k * 300 for k in range(20)}},
    {"arr": np.arange(12, dtype=np.float32).reshape(3, 4), "i64": np.arange(3),
     "u8": np.arange(300, dtype=np.uint8).reshape(20, 15)[:, :7],
     "scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float64)},
])
def test_codec_bytes_equal_flax(tree):
    ours = msgpack.packb(tree)
    assert ours == flax.serialization.msgpack_serialize(tree)
    back = msgpack.unpackb(ours)
    _assert_trees_equal(back, flax.serialization.msgpack_restore(ours))


def test_codec_refuses_what_pilotnet_never_holds():
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.unpackb(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="complex"):
        msgpack.packb({"c": 1 + 2j})
    chunked = msgpack.packb({"w": {msgpack.CHUNKED_KEY: True, "shape": {"0": 1}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(chunked)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    variables = [_flax_variables(seed) for seed in (0, 1)]
    state = jax_training.EnsembleState(
        params=jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[v["params"] for v in variables]),
        batch_stats=jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                           *[v["batch_stats"] for v in variables]),
        opt_state=None, lr_scale=None)
    paths = [str(tmp_path / f"net-{i}.msgpack") for i in range(2)]
    for i, path in enumerate(paths):
        jax_training.save_net(state, i, path)
    for path, want in zip(paths, variables):
        _assert_trees_equal(training.load_net(path), want)
    _assert_trees_equal(training.load_ensemble_params(paths),
                        jax.tree_util.tree_map(np.asarray,
                                               jax_training.load_ensemble_params(paths)))
    net = models.make_network(OPTIONS, BIAS, SHAPE)
    convert.load_flax_variables(net, training.load_net(paths[1]))
    _assert_trees_equal(convert.flax_variables(net), variables[1])


def test_port_checkpoint_loads_in_jax_and_bytes_equal_flax(tmp_path):
    torch.manual_seed(0)
    net = models.make_network(OPTIONS, BIAS, SHAPE)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
                module.running_mean.uniform_(-0.1, 0.1)
                module.running_var.uniform_(0.5, 1.5)
    path = str(tmp_path / "port.msgpack")
    training.save_module(net, path)
    tree = convert.flax_variables(net)
    with open(path, "rb") as f:
        assert f.read() == flax.serialization.msgpack_serialize(tree)
    _assert_trees_equal(jax_training.load_net(path), tree)
    # The flax net built from the port's file computes what the port does.
    rng = np.random.default_rng(2)
    inputs = {models.FRAME_IMG: rng.uniform(0, 1, (2,) + SHAPE).astype(np.float32),
              models.FORWARD_AXIS: rng.normal(size=(2, 3)).astype(np.float32)}
    want = np.asarray(jax_models.make_network(OPTIONS, BIAS).apply(
        jax_training.load_net(path), inputs, train=False))
    with torch.no_grad():
        got = net.eval()({k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
