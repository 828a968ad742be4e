"""predict_video: the JAX CLI and the port's CLI on the golden video on the
CPU with the same checkpoints (a 3-net PilotNet ensemble at 66x200x3, flax
init parameters with batch-norm statistics from a numpy seed, written by
the JAX package's save_net). The steering JSONs hold the same frames, and
each frame's steering agrees within 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.cli import predict_video as jax_cli
from pilotguru_tpu.formats import json_io
from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu.ml import training as jax_training
from pilotguru_tpu_torch.cli import predict_video as port_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(REPO, "tests", "golden", "inputs")
EXPECTED = os.path.join(REPO, "tests", "golden", "expected")
SETTINGS = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 3,
            "target_height": 66, "target_width": 200}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("nets")
    options = {jax_models.NET_NAME: "nvidia", jax_models.NET_HEAD_DIMS: 10,
               jax_models.LABEL_DIMENSIONS: 3, jax_models.DROPOUT_PROB: 0.0,
               jax_models.LAYER_BLOCKS_OPTIONS: jax_models.DEFAULT_LAYER_BLOCKS_OPTIONS}
    model = jax_models.make_network(
        options, [{"input_name": jax_models.FORWARD_AXIS, "input_dims": 3}])
    rng = np.random.default_rng(0)
    params, stats = [], []
    for seed in range(3):
        v = model.init({"params": jax.random.PRNGKey(seed)},
                       {"frame_img": jnp.zeros((1, 66, 200, 3)),
                        "forward_axis": jnp.zeros((1, 3))}, train=False)
        params.append(jax.tree_util.tree_map(
            lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), v["params"]))
        stats.append(jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                             else rng.normal(0, 0.05, x.shape)).astype(np.float32),
            v["batch_stats"]))
    state = jax_training.EnsembleState(
        params=jax.tree_util.tree_map(lambda *x: jnp.stack(x), *params),
        batch_stats=jax.tree_util.tree_map(lambda *x: jnp.stack(x), *stats),
        opt_state=None, lr_scale=None)
    paths = [str(root / f"net-{i}.msgpack") for i in range(3)]
    for i, path in enumerate(paths):
        jax_training.save_net(state, i, path)
    settings = str(root / "settings.json")
    json_io.write_json(SETTINGS, settings)
    return paths, settings


@pytest.mark.parametrize("extra", [["--trajectory_frame_update_rate=0.7"],
                                   ["--convert_to_yuv=1", "--crop_left=10"]])
def test_port_predicts_what_jax_predicts(checkpoints, tmp_path, monkeypatch, extra):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    paths, settings = checkpoints
    outs = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        outs[name] = str(tmp_path / f"{name}.json")
        assert cli.main([
            f"--in_video={INPUTS}/video.mp4",
            f"--forward_axis_json={EXPECTED}/forward_axis.json",
            f"--net_settings_json={settings}",
            f"--in_model_weights={','.join(paths)}",
            f"--out_steering_json={outs[name]}",
            "--crop_top=60", "--crop_bottom=40", "--cuda_device_id=3",
        ] + extra) == 0
    want = json_io.read_json(outs["jax"])["steering"]
    got = json_io.read_json(outs["port"])["steering"]
    assert [e["frame_id"] for e in got] == [e["frame_id"] for e in want] == list(range(120))
    w = np.array([e["steering"] for e in want])
    g = np.array([e["steering"] for e in got])
    assert np.isfinite(g).all() and np.std(w) > 1e-4
    np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
