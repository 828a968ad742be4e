"""The port's train and hyperparams_search CLIs against the JAX package's on
a tiny npz set on the CPU (ToyConvNet, dropout 0, no augmentation,
--batch_use_prob=0.7, plateau patience 1), both starting from the same
checkpoints written by the JAX package (--base_preload_dir /
--preload_dir, so the two packages' other init draws do not matter): the
logs (per-net losses within float32 tolerance; markers, lr_scale and keys
equal), the checkpoint files that exist, and their parameters. Also
checkpoints across the packages both ways, and a port-only user journey:
make_steering_dataset -> train -> predict_video."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from pilotguru_tpu.cli import hyperparams_search as jax_search
from pilotguru_tpu.cli import train as jax_train
from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu.ml import training as jax_training
from pilotguru_tpu_torch.cli import hyperparams_search, train
from pilotguru_tpu_torch.ml import convert, training

torch.set_num_threads(2)

H, W, TARGET = 40, 44, 40
TOY = {"net_name": "toy", "net_head_dims": 10, "label_dimensions": 1, "dropout_prob": 0.0}
WEIGHTER = json.dumps({"name": "exp_recent_loss", "recent_loss_lr": 0.5,
                       "recent_loss_exp_scale": 2.0, "raw_weight_clip": 4.0})


def _write_examples(root, n, seed):
    """Frames whose bright column's position sets the label."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        col = int(rng.integers(4, W - 4))
        img = rng.integers(0, 60, (3, H, W), dtype=np.uint8)
        img[:, :, col - 2:col + 2] = 230
        np.savez(os.path.join(root, f"frame-{i:06d}-data.npz"), frame_img=img,
                 steering=np.array([(col - W / 2) / W], np.float32),
                 forward_axis=rng.normal(size=(3,)).astype(np.float32))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("toyset")
    _write_examples(str(root / "train"), 48, 0)
    _write_examples(str(root / "val"), 16, 1)
    return root


def _jax_init_checkpoints(out_dir, nets, seed):
    """``nets`` ToyConvNet checkpoints from the JAX package's init."""
    model = jax_models.make_network(TOY, [])
    tx = jax_training.make_optimizer("sgd", 0.1)
    state = jax_training.init_ensemble(
        model, {"frame_img": np.zeros((1, H, TARGET, 3), np.float32)}, nets, tx, seed=seed)
    for i in range(nets):
        jax_training.save_net(state, i, os.path.join(out_dir, f"model-{i}-last.msgpack"))


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _compare_logs(got, want, per_net_keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in per_net_keys:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6, err_msg=key)
        for key in ("improvement_marker", "lr_scale_per_net", "epoch"):
            assert g.get(key) == w.get(key), key


def _compare_checkpoints(got_dir, want_dir):
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(want_dir, "*.msgpack")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(got_dir, "*.msgpack")))
    for name in names:
        # The port's file read by the JAX package's reader.
        got = _flat(jax_training.load_net(os.path.join(got_dir, name)))
        want = _flat(jax_training.load_net(os.path.join(want_dir, name)))
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=2e-5,
                                       err_msg=f"{name} {key}")
    return names


def test_train_cli_against_the_jax_cli(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    preload = str(tmp_path / "preload")
    _jax_init_checkpoints(preload, 2, seed=4)
    argv = [f"--data_dirs={dataset}/train", f"--validation_data_dirs={dataset}/val",
            "--batch_size=8", "--batch_use_prob=0.7", "--epochs=4", "--optimizer=sgd",
            "--learning_rate=0.03", "--plateau_patience_epochs=1",
            f"--target_height={H}", f"--target_width={TARGET}", "--net_name=toy",
            "--net_input_names=frame_img", "--linear_bias_options=[]",
            "--num_nets_to_train=2", f"--sample_weighter_options={WEIGHTER}",
            f"--base_preload_dir={preload}", "--seed=3"]
    assert jax_train.main(argv + [f"--out_dir={tmp_path}/jax"]) == 0
    assert train.main(argv + [f"--out_dir={tmp_path}/port"]) == 0
    want = _log(f"{tmp_path}/jax/train_log.jsonl")
    got = _log(f"{tmp_path}/port/train_log.jsonl")
    _compare_logs(got, want, ("train_loss_per_net", "val_loss_per_net", "train_loss",
                              "val_loss"))
    # The run covers both markers' cases and the plateau halving.
    assert {e["improvement_marker"] for e in want} >= {"***"}
    assert any(s != 1.0 for e in want for s in e["lr_scale_per_net"])
    names = _compare_checkpoints(f"{tmp_path}/port", f"{tmp_path}/jax")
    assert {"model-0-last.msgpack", "model-1-last.msgpack", "model-0-best.msgpack"} <= set(names)


def test_hyperparams_search_cli_against_the_jax_cli(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    base = {"input_names": ["frame_img"], "label_names": ["steering"], "net_name": "toy",
            "target_height": H, "target_width": TARGET, "linear_bias_options": [],
            "optimizer": "sgd", "plateau_patience_epochs": 1, "batch_size": 8,
            "sample_weighter_options": json.loads(WEIGHTER)}
    folds = {"a-lr1": {**base, "learning_rate": 0.03},
             "b-lr2": {**base, "learning_rate": 0.015},
             "c-bs": {**base, "learning_rate": 0.03, "batch_size": 12}}
    settings_dir = tmp_path / "settings"
    settings_dir.mkdir()
    for sid, settings in folds.items():
        with open(settings_dir / f"{sid}.json", "w") as f:
            json.dump({**settings, "settings_id": sid}, f)
        _jax_init_checkpoints(str(tmp_path / "preload" / sid), 1, seed=len(sid) + ord(sid[0]))
    assert [len(g) for g in hyperparams_search.group_folds(
        [dict(v, settings_id=k) for k, v in folds.items()])] == [2, 1]
    assert hyperparams_search.group_signature(folds["a-lr1"]) == jax_search.group_signature(
        folds["a-lr1"])
    for pkg, main in (("jax", jax_search.main), ("port", hyperparams_search.main)):
        assert main([f"--data_dirs={dataset}/train", f"--validation_data_dirs={dataset}/val",
                     f"--train_settings_json_glob={settings_dir}/*.json", "--epochs=2",
                     f"--preload_dir={tmp_path}/preload", f"--out_dir={tmp_path}/{pkg}/out",
                     f"--log_dir={tmp_path}/{pkg}/log", "--num_nets_to_train=1",
                     "--batch_use_prob=0.7"]) == 0
    for sid in folds:
        want = _log(f"{tmp_path}/jax/log/{sid}/train_log.jsonl")
        got = _log(f"{tmp_path}/port/log/{sid}/train_log.jsonl")
        _compare_logs(got, want, ("train_loss_per_net", "val_loss_per_net", "train_loss",
                                  "val_loss"))
        _compare_checkpoints(f"{tmp_path}/port/out/{sid}", f"{tmp_path}/jax/out/{sid}")
        assert os.path.isfile(f"{tmp_path}/port/out/{sid}/model-0-last.msgpack")


def test_checkpoints_cross_between_the_packages(tmp_path):
    model = jax_models.make_network(TOY, [])
    tx = jax_training.make_optimizer("sgd", 0.1)
    jax_state = jax_training.init_ensemble(
        model, {"frame_img": np.zeros((1, H, TARGET, 3), np.float32)}, 2, tx, seed=9)
    jax_training.save_net(jax_state, 1, str(tmp_path / "jax.msgpack"))
    params, stats = convert.ensemble_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_state.params),
        jax.tree_util.tree_map(np.asarray, jax_state.batch_stats))
    state = training.EnsembleState(params, stats, {}, torch.ones(2))
    training.save_net(state, 1, str(tmp_path / "port.msgpack"))
    with open(tmp_path / "jax.msgpack", "rb") as a, open(tmp_path / "port.msgpack", "rb") as b:
        assert a.read() == b.read()
    back = _flat(jax_training.load_net(str(tmp_path / "port.msgpack")))
    for key, value in _flat(training.load_net(str(tmp_path / "jax.msgpack"))).items():
        np.testing.assert_array_equal(back[key], value)
    stacked = training.load_ensemble_params([str(tmp_path / "jax.msgpack")] * 2)
    p2, _ = convert.ensemble_from_flax(stacked["params"], stacked["batch_stats"])
    for key, value in _flat(convert.ensemble_to_flax(p2, {})[0]).items():
        np.testing.assert_array_equal(value[0], _flat(convert.ensemble_to_flax(params, {})[0])
                                      [key][1])


def test_port_user_journey_dataset_train_predict(tmp_path, monkeypatch):
    """make_steering_dataset -> train -> predict_video, all the port's, on
    a PNG list of 90 frames whose bar follows the yaw rate."""
    from pilotguru_tpu_torch.cli import make_steering_dataset, predict_video
    from pilotguru_tpu_torch.formats import json_io, keys
    from pilotguru_tpu_torch.video.io import write_image_list

    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    n, fps, t0 = 90, 10.0, 1_000_000
    times = [t0 + int(i * 1e6 / fps) for i in range(n)]

    def yaw(t_sec):
        return 0.5 * np.sin(2 * np.pi * t_sec / 4.5)

    def frames():
        for t in times:
            img = np.full((48, 64, 3), 30, np.uint8)
            x = int(round(32 + 26 * yaw((t - t0) * 1e-6) / 0.5))
            img[:, max(x - 2, 0):x + 2] = (250, 180, 40)
            yield img

    images = write_image_list(str(tmp_path / "frames"), frames(), times)
    json_io.write_json({keys.FRAMES: [{keys.FRAME_ID: i, keys.TIME_USEC: t}
                                      for i, t in enumerate(times)]}, str(tmp_path / "frames.json"))
    imu = np.arange(t0 - 100_000, times[-1] + 100_000, 10_000, dtype=np.int64)
    json_io.write_timestamped_values(imu, yaw((imu - t0) * 1e-6), str(tmp_path / "steer.json"),
                                     keys.STEERING, "angular_velocity")
    json_io.write_timestamped_values(imu, np.full(imu.shape, 8.0), str(tmp_path / "vel.json"),
                                     keys.VELOCITIES, keys.SPEED_M_S)
    json_io.write_forward_axis(np.array([1.0, 0.0, 0.0]), str(tmp_path / "forward.json"))
    json_io.write_json({"crop_settings": {}}, str(tmp_path / "crop.json"))
    data_dir = str(tmp_path / "dataset")
    assert make_steering_dataset.main([
        f"--in_video={images}", f"--in_frames_json={tmp_path}/frames.json",
        f"--in_steering_json={tmp_path}/steer.json", "--steering_source=imu",
        f"--in_velocities_json={tmp_path}/vel.json",
        f"--in_forward_axis_json={tmp_path}/forward.json",
        f"--crop_settings_json={tmp_path}/crop.json", f"--out_dir={data_dir}",
        "--frames_step=1", "--target_height=48", "--target_width=64"]) == 0
    assert len(glob.glob(os.path.join(data_dir, "*-data.npz"))) > 80
    model_dir = str(tmp_path / "models")
    assert train.main([f"--data_dirs={data_dir}", f"--validation_data_dirs={data_dir}",
                       "--batch_size=16", "--epochs=12", "--optimizer=adam",
                       "--learning_rate=3e-3", "--target_height=48", "--target_width=64",
                       "--net_name=toy", "--num_nets_to_train=2",
                       f"--out_dir={model_dir}"]) == 0
    log = _log(os.path.join(model_dir, "train_log.jsonl"))
    assert log[-1]["train_loss"] < 0.5 * log[0]["train_loss"]
    checkpoints = [os.path.join(model_dir, f"model-{i}-best.msgpack") for i in range(2)]
    with open(tmp_path / "net.json", "w") as f:
        json.dump({"net_name": "toy", "target_height": 48, "target_width": 64}, f)
    out = str(tmp_path / "predicted.json")
    assert predict_video.main([f"--in_video={images}", f"--forward_axis_json={tmp_path}/forward.json",
                               f"--net_settings_json={tmp_path}/net.json",
                               f"--in_model_weights={','.join(checkpoints)}",
                               f"--out_steering_json={out}"]) == 0
    predicted = np.array([e["steering"] for e in json_io.read_json(out)["steering"]])
    truth = yaw((np.array(times) - t0) * 1e-6)
    assert predicted.shape == (n,) and np.isfinite(predicted).all()
    assert np.corrcoef(predicted, truth)[0, 1] > 0.5


def _flags(path):
    """The --flags a CLI module's main() adds, with their defaults."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            flags[node.args[0].value] = (kw.get("default"), kw.get("type"), kw.get("required"))
    return flags


@pytest.mark.parametrize("name,extra", [("train", {"--compute_dtype"}),
                                        ("hyperparams_search", set())])
def test_cli_flags_are_the_jax_clis(name, extra):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = _flags(os.path.join(repo, "pilotguru_tpu", "cli", f"{name}.py"))
    got = _flags(os.path.join(repo, "pilotguru_tpu_torch", "cli", f"{name}.py"))
    if name == "hyperparams_search":  # add_dtype_flag: the same --dtype in both
        assert "--dtype" not in want and "--dtype" not in got
    assert set(got) - set(want) == extra and set(want) <= set(got)
    for flag, spec in want.items():
        assert got[flag] == spec, flag


def test_train_on_cuda_without_a_card_raises(dataset, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("PILOTGURU_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([f"--data_dirs={dataset}/train", f"--validation_data_dirs={dataset}/val",
                    "--batch_size=8", "--epochs=1", f"--target_height={H}",
                    f"--target_width={TARGET}", "--net_name=toy", f"--out_dir={tmp_path}"])
