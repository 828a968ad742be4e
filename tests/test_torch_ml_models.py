"""The port's steering nets (pilotguru_tpu_torch/ml/models.py) against the
JAX package's flax nets: the flax ``init`` parameters, with the batch-norm
statistics, scales and the LinearBias kernel drawn at random from a numpy
seed, carried across by ml/convert.py; the same float32 inputs; outputs in
eval mode within 1e-5 absolute + 1e-5 relative (float32 rounding of
convolutions summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ml import nvidia_param_count

from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu_torch.ml import convert, models

torch.set_num_threads(2)

BIAS = [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]
# The rambo and deep nets need the taller 100x300 crop, as in tests/test_ml.py.
SHAPES = {"toy": (66, 200, 3), "nvidia": (66, 200, 3), "rambo": (100, 300, 3),
          "rambo-comma": (100, 300, 3), "nvidia-deep": (100, 300, 3),
          "rambo-nvidia-deep": (100, 300, 3), "rambo-nvidia-shallow": (100, 300, 3)}


def _options(name, **extra):
    return {models.NET_NAME: name, models.NET_HEAD_DIMS: 10, models.LABEL_DIMENSIONS: 2,
            models.DROPOUT_PROB: 0.3,
            models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS, **extra}


def _randomized(variables, seed):
    """flax init's params, with batch norm's statistics, scale and bias and
    the (zero-initialised) LinearBias kernel drawn from numpy ``seed``."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
                continue
            value = np.asarray(value, np.float32)
            if key == "var":
                value = rng.uniform(0.5, 1.5, value.shape)
            elif key in ("mean", "bias") and "BatchNorm_0" in path:
                value = rng.normal(0, 0.1, value.shape)
            elif key == "scale":
                value = rng.uniform(0.5, 1.5, value.shape)
            elif "LinearBias_0" in path:
                value = rng.normal(0, 0.1, value.shape)
            out[key] = np.asarray(value, np.float32)
        return out

    return {k: walk(v, ()) for k, v in variables.items()}


def _flax_variables(name, shape, seed=0):
    model = jax_models.make_network(_options(name), BIAS)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        {models.FRAME_IMG: jnp.zeros((2,) + shape, jnp.float32),
         models.FORWARD_AXIS: jnp.zeros((2, 3), jnp.float32)},
        train=False)
    return model, _randomized(jax.tree_util.tree_map(np.asarray, dict(variables)), seed)


def _inputs(shape, batch=3, seed=1):
    rng = np.random.default_rng(seed)
    return {models.FRAME_IMG: rng.uniform(0, 1, (batch,) + shape).astype(np.float32),
            models.FORWARD_AXIS: rng.normal(0, 1, (batch, 3)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_net_matches_flax(name):
    shape = SHAPES[name]
    flax_model, variables = _flax_variables(name, shape)
    inputs = _inputs(shape)
    want = np.asarray(flax_model.apply(variables, inputs, train=False))
    net = models.make_network(_options(name), BIAS, shape).eval()
    convert.load_flax_variables(net, variables)
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    assert got.shape == want.shape == (3, 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # The forward axis reaches the output: the LinearBias kernel is loaded.
    assert np.abs(want).max() > 1e-3


def test_flatten_order_is_the_flax_one():
    """At 66x200 the PilotNet trunk ends at 1x18x64: flattening NCHW as
    (C, H, W) instead of (H, W, C) gives other numbers."""
    shape = SHAPES["nvidia"]
    flax_model, variables = _flax_variables("nvidia", shape)
    inputs = _inputs(shape)
    want = np.asarray(flax_model.apply(variables, inputs, train=False))
    net = models.make_network(_options("nvidia"), BIAS, shape).eval()
    convert.load_flax_variables(net, variables)
    original = models._flatten
    try:
        models._flatten = lambda x: x.flatten(1)
        with torch.no_grad():
            wrong = net({k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    finally:
        models._flatten = original
    assert np.abs(wrong - want).max() > 1e-3


def test_nvidia_param_count_matches_the_formula():
    net = models.make_network(_options("nvidia"), (), (66, 200, 3))
    count = sum(p.numel() for p in net.parameters())
    assert count == nvidia_param_count(66, 200, 3, 10, 2)
    # About 1.6 M parameters at the published 66x200x3 input.
    assert 1.5e6 < count < 1.7e6


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flax_tree_round_trip(name):
    """flax tree -> port net -> flax tree gives back every array."""
    shape = SHAPES[name]
    _, variables = _flax_variables(name, shape, seed=3)
    net = models.make_network(_options(name), BIAS, shape)
    convert.load_flax_variables(net, variables)
    back = convert.flax_variables(net)
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], value)


def test_bfloat16_compute_dtype_is_an_explicit_cast():
    """compute_dtype bfloat16: parameters stay float32, the output is
    float32, and it lies near the float32 net's (bfloat16 keeps 8 bits)."""
    shape = SHAPES["nvidia"]
    _, variables = _flax_variables("nvidia", shape)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(shape).items()}
    outs = {}
    for dtype in ("float32", "bfloat16"):
        net = models.make_network(_options("nvidia", compute_dtype=dtype), BIAS, shape).eval()
        convert.load_flax_variables(net, variables)
        assert all(p.dtype == torch.float32 for p in net.parameters())
        with torch.no_grad():
            outs[dtype] = net(inputs)
    assert outs["bfloat16"].dtype == torch.float32
    scale = outs["float32"].abs().max()
    assert (outs["bfloat16"] - outs["float32"]).abs().max() < 0.1 * scale
    assert models.resolve_compute_dtype({}, "cpu") == torch.float32
    assert models.resolve_compute_dtype({}, "cuda") == torch.bfloat16


def test_unknown_layers_in_a_flax_tree_raise():
    shape = SHAPES["nvidia"]
    _, variables = _flax_variables("nvidia", shape)
    variables["params"]["Dense_7"] = {"kernel": np.zeros((3, 3), np.float32)}
    net = models.make_network(_options("nvidia"), BIAS, shape)
    with pytest.raises(KeyError, match="Dense_7"):
        convert.load_flax_variables(net, variables)
