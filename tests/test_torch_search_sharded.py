"""The search's super-ensemble spread over devices
(cli/hyperparams_search.py: run_training_group; ml/training.py:
train_models with ``devices``) on the CPU, on tests/test_torch_train_cli.py's
tiny npz set.

- A four-net group of ToyConvNet (the per-net path) with dropout over
  ``[cpu] * 2`` and ``[cpu] * 4`` against the same group unsharded: logs
  (but their seconds) and checkpoint files equal to the bit, each net
  drawing its dropout masks from the one generator in net order.
- A four-net PilotNet group (the folded path) with augmentation and dropout
  over ``[cpu] * 2``: the augmentation is drawn once and the dropout masks
  are the whole ensemble's, sliced by block, so the runs differ only by
  rounding: the folded batch norm's batch mean over (batch, height, width)
  of N x C channels, whose CPU reduction order changes with the channel
  count (measured: 6e-8 on conv1's means at N = 4 against 2 + 2). After
  one epoch of two steps at learning rate 1e-3 the per-net losses are
  held within rtol 2e-5 and the checkpoints' parameters within 1e-4
  (PILOTNET_BARS; measured 4.9e-6 and 2.9e-5 over two devices, 6.1e-6
  and 1.9e-6 over four; a second epoch amplifies them to 1.5e-3, as this
  training amplifies rounding, ROADMAP.md Queue 3).
- A group whose net count the device count does not divide runs unsharded
  on the first device, as the JAX package's does.
- The JAX search CLI with 8 nets (two folds of 4) over the 8 virtual
  devices of tests/conftest.py, which shards its net axis, against the
  port's CLI over four CPU devices, within tests/test_torch_train_cli.py's
  bars for logs and checkpoints, at learning rates 3e-3 and 1.5e-3. At
  that file's 0.03 one of the 8 nets reads 4.9e-4 (relative) from the JAX
  CLI in its first epoch's loss, and at 0.01 another 2.5e-4, whether or
  not either package shards (the JAX CLI over 8 devices and over 1 agree
  to 5e-9; the port's sharded run equals its unsharded one to the bit):
  float32 rounding that SGD amplifies, ROADMAP.md Queue 3.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pilotguru_tpu.cli import hyperparams_search as jax_search
from pilotguru_tpu_torch.cli import hyperparams_search
from pilotguru_tpu_torch.ml import data as data_lib
from pilotguru_tpu_torch.ml import training
from test_torch_train_cli import (
    TARGET,
    WEIGHTER,
    H,
    _compare_checkpoints,
    _compare_logs,
    _jax_init_checkpoints,
    _log,
    _write_examples,
)

torch.set_num_threads(2)

TOY = {"input_names": ["frame_img"], "label_names": ["steering"], "net_name": "toy",
       "target_height": H, "target_width": TARGET, "linear_bias_options": [],
       "optimizer": "sgd", "plateau_patience_epochs": 1, "batch_size": 8,
       "sample_weighter_options": json.loads(WEIGHTER)}
PILOTNET = {"input_names": ["frame_img"], "label_names": ["steering"], "net_name": "nvidia",
            "target_height": 66, "target_width": 200, "linear_bias_options": [],
            "optimizer": "sgd", "batch_size": 8, "dropout_prob": 0.3,
            "max_horizontal_shift_pixels": 4, "train_blur_prob": 0.5,
            "grayscale_interpolate_prob": 0.3}
# The folded path sharded against unsharded after one epoch of two steps:
# per-net losses (relative) and checkpoint parameters (absolute).
PILOTNET_BARS = {"loss_rtol": 2e-5, "param_atol": 1e-4}


@pytest.fixture(scope="module")
def toyset(tmp_path_factory):
    root = tmp_path_factory.mktemp("toyset")
    _write_examples(str(root / "train"), 48, 0)
    _write_examples(str(root / "val"), 16, 1)
    return root


@pytest.fixture(scope="module")
def roadset(tmp_path_factory):
    """16 + 8 random 66x210 frames for PilotNet."""
    root = tmp_path_factory.mktemp("roadset")
    rng = np.random.default_rng(5)
    for name, n in (("train", 16), ("val", 8)):
        os.makedirs(root / name)
        for i in range(n):
            np.savez(root / name / f"frame-{i:06d}-data.npz",
                     frame_img=rng.integers(0, 255, (3, 66, 210), dtype=np.uint8),
                     steering=np.array([rng.normal()], np.float32))
    return root


def _run_group(root, data, folds, devices, tag, num_nets, epochs):
    names = folds[0]["input_names"] + folds[0]["label_names"]
    train = data_lib.load_dataset([f"{data}/train"], names, "data.npz")
    val = data_lib.load_dataset([f"{data}/val"], names, "data.npz")
    hyperparams_search.run_training_group(
        folds, train, val, epochs=epochs, num_nets=num_nets, batch_use_prob=0.7,
        out_root=f"{root}/{tag}/out", log_root=f"{root}/{tag}/log", device="cpu",
        devices=devices)
    logs, files = {}, {}
    for settings in folds:
        sid = settings["settings_id"]
        logs[sid] = [{k: v for k, v in e.items() if not k.endswith("_sec")}
                     for e in _log(f"{root}/{tag}/log/{sid}/train_log.jsonl")]
        for path in sorted(glob.glob(f"{root}/{tag}/out/{sid}/*.msgpack")):
            files[f"{sid}/{os.path.basename(path)}"] = path
    return logs, files


def _folds(base, learning_rate=0.03, **extra):
    return [dict(base, learning_rate=learning_rate, settings_id="a", **extra),
            dict(base, learning_rate=learning_rate / 2, settings_id="b", **extra)]


@pytest.mark.parametrize("k", [2, 4])
def test_toy_group_sharded_equals_unsharded_to_the_bit(toyset, tmp_path, k):
    folds = _folds(TOY, dropout_prob=0.3)
    want_logs, want_files = _run_group(tmp_path, toyset, folds, None, "one", 2, 3)
    got_logs, got_files = _run_group(tmp_path, toyset, folds, ["cpu"] * k, "sharded", 2, 3)
    assert got_logs == want_logs
    assert len(want_logs["a"]) == 3
    assert got_files.keys() == want_files.keys() and len(want_files) >= 8
    for key, path in want_files.items():
        with open(path, "rb") as a, open(got_files[key], "rb") as b:
            assert a.read() == b.read(), key


def test_pilotnet_group_sharded_within_rounding(roadset, tmp_path):
    folds = _folds(PILOTNET, learning_rate=0.001)
    want_logs, want_files = _run_group(tmp_path, roadset, folds, None, "one", 2, 1)
    got_logs, got_files = _run_group(tmp_path, roadset, folds, ["cpu"] * 2, "sharded", 2, 1)
    for sid in want_logs:
        for g, w in zip(got_logs[sid], want_logs[sid]):
            for key in ("train_loss_per_net", "val_loss_per_net"):
                np.testing.assert_allclose(g[key], w[key], rtol=PILOTNET_BARS["loss_rtol"],
                                           atol=0, err_msg=key)
            assert g["epoch"] == w["epoch"]
    assert got_files.keys() == want_files.keys()
    for key, path in want_files.items():
        want = _flat(training.load_net(path))
        got = _flat(training.load_net(got_files[key]))
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, rtol=0,
                                       atol=PILOTNET_BARS["param_atol"], err_msg=name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_group_whose_net_count_does_not_divide_runs_unsharded(toyset, tmp_path, monkeypatch):
    seen = []
    real = training.train_models

    def spy(*args, devices=None, **kwargs):
        seen.append((args[1].lr_scale.device, devices))
        return real(*args, devices=devices, **kwargs)

    monkeypatch.setattr(training, "train_models", spy)
    folds = _folds(TOY)[:1]
    want = _run_group(tmp_path, toyset, folds, None, "one", 3, 1)
    got = _run_group(tmp_path, toyset, folds, ["cpu"] * 2, "two", 3, 1)
    assert seen == [(torch.device("cpu"), None)] * 2
    assert got[0] == want[0]


def test_search_cli_sharded_against_the_jax_cli_over_8_devices(toyset, tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    nets = 4
    settings_dir = tmp_path / "settings"
    settings_dir.mkdir()
    for f, settings in enumerate(_folds(TOY, learning_rate=3e-3)):
        with open(settings_dir / f"{settings['settings_id']}.json", "w") as out:
            json.dump(settings, out)
        _jax_init_checkpoints(str(tmp_path / "preload" / settings["settings_id"]), nets,
                              seed=11 + f)
    seen = []
    real = training.train_models

    def spy(*args, devices=None, **kwargs):
        seen.append(devices)
        return real(*args, devices=devices, **kwargs)

    monkeypatch.setattr(training, "train_models", spy)
    monkeypatch.setattr(hyperparams_search, "search_devices",
                        lambda device: [torch.device("cpu")] * 4)
    for pkg, main in (("jax", jax_search.main), ("port", hyperparams_search.main)):
        assert main([f"--data_dirs={toyset}/train", f"--validation_data_dirs={toyset}/val",
                     f"--train_settings_json_glob={settings_dir}/*.json", "--epochs=2",
                     f"--preload_dir={tmp_path}/preload", f"--out_dir={tmp_path}/{pkg}/out",
                     f"--log_dir={tmp_path}/{pkg}/log", f"--num_nets_to_train={nets}",
                     "--batch_use_prob=0.7"]) == 0
    assert seen == [[torch.device("cpu")] * 4]
    for sid in ("a", "b"):
        want = _log(f"{tmp_path}/jax/log/{sid}/train_log.jsonl")
        got = _log(f"{tmp_path}/port/log/{sid}/train_log.jsonl")
        _compare_logs(got, want, ("train_loss_per_net", "val_loss_per_net", "train_loss",
                                  "val_loss"))
        names = _compare_checkpoints(f"{tmp_path}/port/out/{sid}", f"{tmp_path}/jax/out/{sid}")
        assert {f"model-{i}-last.msgpack" for i in range(nets)} <= set(names)
