"""predict_live and the saliency of render_input_pixel_importance: the
port against the JAX package on the CPU, with a 2-net toy ensemble
(ToyConvNet at 36x64x3) whose weights come from a numpy seed and are
written as flax msgpack by the port's codec, over a 20-frame 64x48 noise
video (the tiny video of tests/test_tools.py).

- predict_live: a SUB thread on ipc:// receives {"s": degrees}; every value
  is finite and the values are, in order, a subsequence of the port's
  predict_video steering x --prediction_units_to_degrees_scale on the same
  frames within 1e-5 (the PUB socket conflates, and the first messages may
  go before the subscription lands). The JAX predict_live gives the same
  property against the same reference. The references lie between -4.7
  and -4.4 degrees, and the JAX predict_video is within 1.7e-6 degrees of
  the port's (measured). --log_dir writes frames.json and a video of every
  predicted frame.
- saliency: the port's [B, H, W] map (torch.autograd) against the JAX CLI's
  jax.grad map on the same checkpoints and frames in float32, within 1e-5
  of the map's largest value; the CLI writes --max_out_frames frames at
  the crop size, as tests/test_tools.py checks the JAX CLI.

Every video read decodes through cv2 (``cv2_decode_route``), the route the
JAX CLIs always take, so the two packages see the same pixels whether or
not tests/test_native_video.py has built native/build/libpgvideo.so.
"""

import os
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zmq

from pilotguru_tpu.cli import predict_live as jax_live
from pilotguru_tpu.cli import predict_video as jax_predict_video
from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu_torch.cli import predict_live, predict_video, render_input_pixel_importance
from pilotguru_tpu_torch.formats import json_io
from pilotguru_tpu_torch.ml import convert, models
from pilotguru_tpu_torch.utils import msgpack
from pilotguru_tpu_torch.video import native as native_video
from pilotguru_tpu_torch.video.io import read_video_rgb

torch.set_num_threads(2)

SCALE = 90.0
SETTINGS = {"net_name": "toy", "net_head_dims": 10, "label_dimensions": 1, "dropout_prob": 0.0,
            "target_height": 36, "target_width": 64,
            "linear_bias_options": [{"input_name": models.FORWARD_AXIS, "input_dims": 3}]}
CROP = ["--crop_top=12"]


@pytest.fixture(scope="module", autouse=True)
def cv2_decode_route():
    """The port decodes through cv2, as the JAX CLIs do (module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_video, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(video, settings JSON, checkpoint paths, forward-axis JSON)."""
    root = tmp_path_factory.mktemp("live")
    rng = np.random.default_rng(0)
    video = str(root / "tiny.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for frame in rng.integers(0, 255, size=(20, 48, 64, 3), dtype=np.uint8):
        writer.write(frame)
    writer.release()
    net = models.make_network(
        {models.NET_NAME: "toy", models.NET_HEAD_DIMS: 10, models.LABEL_DIMENSIONS: 1,
         models.DROPOUT_PROB: 0.0, models.LAYER_BLOCKS_OPTIONS: models.DEFAULT_LAYER_BLOCKS_OPTIONS},
        SETTINGS["linear_bias_options"], (36, 64, 3))
    template = convert.flax_variables(net)
    paths = []
    for i in range(2):
        draw = np.random.default_rng(10 + i)

        def fill(node, key=""):
            if isinstance(node, dict):
                return {k: fill(v, k) for k, v in node.items()}
            if key == "var":
                return draw.uniform(0.5, 1.5, node.shape).astype(np.float32)
            if key == "kernel":  # variance 1 / fan_in
                scale = 1.0 / np.sqrt(np.prod(node.shape[:-1]))
            else:
                scale = 1.0 if key in ("scale", "mean") else 0.1
            return (draw.normal(size=node.shape) * scale).astype(np.float32)

        variables = fill(template)
        # Predictions of a steering net's size (a few degrees once scaled).
        for layer in (variables["params"]["Dense_2"], variables["params"]["LinearBias_0"]["Dense_0"]):
            for key in layer:
                layer[key] *= np.float32(0.05)
        paths.append(str(root / f"net-{i}.msgpack"))
        with open(paths[-1], "wb") as f:
            f.write(msgpack.packb(variables))
    settings = str(root / "settings.json")
    json_io.write_json(SETTINGS, settings)
    forward = str(root / "forward.json")
    json_io.write_forward_axis([0.8, 0.1, 0.59], forward)
    return video, settings, paths, forward


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory, monkeypatch_module):
    video, settings, paths, forward = inputs
    out = str(tmp_path_factory.mktemp("video") / "steering.json")
    assert predict_video.main([
        f"--in_video={video}", f"--forward_axis_json={forward}",
        f"--net_settings_json={settings}", f"--in_model_weights={','.join(paths)}",
        f"--out_steering_json={out}", "--trajectory_frame_update_rate=0.7"] + CROP) == 0
    steering = np.array([e["steering"] for e in json_io.read_json(out)["steering"]])
    assert len(steering) == 20 and np.std(steering) > 1e-4
    return steering * SCALE


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
        yield mp


def _subscribe(address, received, ready, done):
    """Store every message until ``done`` is set and a receive then times
    out (the publisher may take seconds to load its nets)."""
    context = zmq.Context()
    sub = context.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.RCVTIMEO, 200)
    sub.connect(address)
    ready.set()
    try:
        while True:
            try:
                received.append(sub.recv_json())
            except zmq.Again:
                if done.is_set():
                    return
    finally:
        sub.close(linger=0)
        context.term()


def _run_live(cli, inputs, address, extra):
    video, settings, paths, forward = inputs
    received, ready, done = [], threading.Event(), threading.Event()
    thread = threading.Thread(target=_subscribe, args=(address, received, ready, done),
                              daemon=True)
    thread.start()
    ready.wait(5)
    try:
        rc = cli.main([
            f"--in_video_file={video}", f"--forward_axis_json={forward}",
            f"--net_settings_json={settings}", f"--in_model_weights={','.join(paths)}",
            f"--steering_prediction_socket={address}", "--trajectory_frame_update_rate=0.7",
            "--delay_max_fps=20"] + CROP + extra)
    finally:
        done.set()
    thread.join(timeout=20)
    assert rc == 0 and not thread.is_alive()
    return [m["s"] for m in received]


def _assert_in_order_subsequence(values, reference, atol):
    assert values, "no ZMQ messages received"
    assert np.isfinite(values).all()
    j = 0
    for v in values:
        while j < len(reference) and abs(reference[j] - v) > atol:
            j += 1
        assert j < len(reference), (v, reference)
        j += 1


def test_port_publishes_a_subsequence_of_predict_video(inputs, reference, tmp_path,
                                                       monkeypatch_module):
    log_dir = tmp_path / "log"
    values = _run_live(predict_live, inputs, f"ipc://{tmp_path}/port",
                       [f"--log_dir={log_dir}"])
    _assert_in_order_subsequence(values, reference, 1e-5)
    frames = json_io.read_json(str(log_dir / "frames.json"))["frames"]
    assert [f["frame_id"] for f in frames] == list(range(20))
    logged = list(read_video_rgb(str(log_dir / "video.mp4")))
    assert len(logged) == 20 and logged[0][1].shape == (48, 64, 3)


def test_jax_publishes_the_same_subsequence(inputs, reference, tmp_path, monkeypatch_module):
    values = _run_live(jax_live, inputs, f"ipc://{tmp_path}/jax", [])
    _assert_in_order_subsequence(values, reference, 1e-5)


def _jax_saliency(paths, settings, images, axis):
    """The JAX CLI's saliency (pilotguru_tpu/cli/render_input_pixel_importance.py)."""
    predictor = jax_predict_video.load_predictor(settings, paths)
    model, variables = predictor._model, predictor._variables
    axis = jnp.broadcast_to(jnp.asarray(axis), (images.shape[0], 3))

    def total(imgs):
        def one(p, s):
            return model.apply({"params": p, "batch_stats": s},
                               {jax_models.FRAME_IMG: imgs, jax_models.FORWARD_AXIS: axis},
                               train=False)

        return jnp.sum(jnp.mean(jax.vmap(one)(variables["params"], variables["batch_stats"]),
                                axis=0))

    return np.asarray(jnp.max(jnp.abs(jax.grad(total)(jnp.asarray(images))), axis=-1))


def test_saliency_matches_jax_grad(inputs):
    video, _, paths, forward = inputs
    frames = np.stack([f for _, f in read_video_rgb(video)][:8])[:, 12:]
    images = frames.astype(np.float32) / 255.0
    axis = json_io.read_forward_axis(forward).astype(np.float32)
    predictor = predict_video.load_predictor(dict(SETTINGS, compute_dtype="float32"), paths,
                                             images.shape[1:], "cpu")
    got = render_input_pixel_importance.saliency(
        predictor.nets, torch.from_numpy(images), torch.from_numpy(axis)).numpy()
    want = _jax_saliency(paths, SETTINGS, images, axis)
    assert got.shape == want.shape == (8, 36, 64)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * want.max(), rtol=0)


def test_saliency_cli_writes_the_crop(inputs, tmp_path, monkeypatch_module):
    video, settings, paths, forward = inputs
    out = str(tmp_path / "saliency.mp4")
    assert render_input_pixel_importance.main([
        f"--in_video={video}", f"--out_video={out}", f"--forward_axis_json={forward}",
        f"--net_settings_json={settings}", f"--in_model_weights={paths[0]}",
        "--batch_size=4", "--max_out_frames=8"] + CROP) == 0
    frames = list(read_video_rgb(out))
    assert len(frames) == 8 and frames[0][1].shape[:2] == (36, 64)
