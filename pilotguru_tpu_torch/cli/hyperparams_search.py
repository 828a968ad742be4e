"""hyperparams_search CLI: grid search over training-settings JSON files.

Flag-compatible with pilotguru_tpu.cli.hyperparams_search (the reference's
python/hyperparams_search.py). As in the JAX package, grid folds whose
settings make the same program (same net, batch size, crop, augmentation,
optimizer family, loss power: PROGRAM_KEYS) are stacked into one
super-ensemble, fold axis x --num_nets_to_train axis, and trained as one
program on the card; folds that need another program form another group,
run after it. The dataset is loaded once for every group. Each fold's
learning rate rides its nets' lr_scale (exact: the SGD and Adam updates
are linear in the learning rate), and each fold's log and checkpoints land
in its own directories under --log_dir and --out_dir.

With several visible cards (CUDA_VISIBLE_DEVICES chooses them), a group
whose net count the card count divides is split into contiguous blocks of
nets, one a card, as the JAX package shards the net axis over its mesh
(ml/training.py: train_models); another group runs on the first card.
--parallelism and --cuda_device_ids are accepted and ignored; --dtype is
accepted for compatibility and unused. A settings JSON may add
"compute_dtype" (float32 | bfloat16), which then joins the group's
signature. The device comes from PILOTGURU_TPU_PLATFORM (cpu | cuda,
default cuda).
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

from pilotguru_tpu_torch.cli._common import add_dtype_flag, make_parser, setup_device

# Settings keys that change the program: folds share a super-ensemble only
# when all of these match.
PROGRAM_KEYS = (
    "net_name",
    "input_names",
    "label_names",
    "target_height",
    "target_width",
    "net_head_dims",
    "label_dimensions",
    "dropout_prob",
    "layer_blocks_options",
    "linear_bias_options",
    "optimizer",
    "loss_norm_pow",
    "plateau_patience_epochs",
    "batch_size",
    "max_horizontal_shift_pixels",
    "horizontal_label_shift_rate",
    "train_blur_sigma",
    "train_blur_prob",
    "grayscale_interpolate_prob",
)
COMPUTE_DTYPE = "compute_dtype"


def group_signature(settings: dict) -> str:
    keys = PROGRAM_KEYS + ((COMPUTE_DTYPE,) if settings.get(COMPUTE_DTYPE) else ())
    return json.dumps({k: settings.get(k) for k in keys}, sort_keys=True)


def group_folds(settings_list):
    """Order-preserving grouping of compatible folds."""
    groups = {}
    order = []
    for settings in settings_list:
        sig = group_signature(settings)
        if sig not in groups:
            groups[sig] = []
            order.append(sig)
        groups[sig].append(settings)
    return [groups[sig] for sig in order]


def run_training_group(
    folds,
    train_data,
    val_data,
    epochs: int,
    num_nets: int,
    batch_use_prob: float,
    out_root: str,
    log_root: str,
    preload_dir=None,
    device="cuda",
    devices=None,
):
    """Train all folds of one program group as one super-ensemble of
    len(folds) * num_nets nets on ``device``, or, given ``devices`` (more
    than one, their count dividing the net count), split over them in
    contiguous blocks of nets; otherwise on the first of ``devices``.
    Under ``utils.profiling.recording(timer)`` it records the spans
    ``search.setup`` (model, init, preload, weighters) and
    ``search.fold_logs`` around train_models' own."""
    import torch

    from pilotguru_tpu_torch.ml import augmentation as aug
    from pilotguru_tpu_torch.ml import convert
    from pilotguru_tpu_torch.ml import data as data_lib
    from pilotguru_tpu_torch.ml import models, training, weighting
    from pilotguru_tpu_torch.utils import profiling

    with profiling.stage("search.setup"):
        first = folds[0]
        input_names = first["input_names"]
        label_name = first["label_names"][0]
        options = {
            models.NET_NAME: first["net_name"],
            models.NET_HEAD_DIMS: first.get("net_head_dims", 10),
            models.LABEL_DIMENSIONS: first.get("label_dimensions", 1),
            models.DROPOUT_PROB: first.get("dropout_prob", 0.0),
            models.LAYER_BLOCKS_OPTIONS: first.get(
                "layer_blocks_options", models.DEFAULT_LAYER_BLOCKS_OPTIONS
            ),
        }
        if first.get(COMPUTE_DTYPE):
            options[models.COMPUTE_DTYPE] = first[COMPUTE_DTYPE]
        shift_rate = first.get("horizontal_label_shift_rate", [0.0])
        base_lr = float(first.get("learning_rate", 1e-3))
        train_settings = training.TrainSettings(
            epochs=epochs,
            batch_size=first["batch_size"],
            learning_rate=base_lr,
            optimizer=first.get("optimizer", training.SGD),
            loss_norm_pow=first.get("loss_norm_pow", 2.0),
            batch_use_prob=batch_use_prob,
            plateau_patience_epochs=first.get("plateau_patience_epochs", 0),
            augment=aug.AugmentSettings(
                target_width=first["target_width"],
                max_horizontal_shift_pixels=first.get(
                    "max_horizontal_shift_pixels", 0
                ),
                horizontal_label_shift_rate=tuple(np.atleast_1d(shift_rate)),
                blur_sigma=first.get("train_blur_sigma", 2.0),
                blur_prob=first.get("train_blur_prob", 0.0),
                grayscale_interpolate_prob=first.get(
                    "grayscale_interpolate_prob", 0.0
                ),
            ),
        )
        example = {}
        for name in input_names:
            arr = train_data[name][:1]
            if name == models.FRAME_IMG:
                arr = data_lib.images_to_float(arr)[
                    :, : first["target_height"], : first["target_width"]
                ]
            example[name] = np.asarray(arr, np.float32)
        model = models.make_network(options, first.get("linear_bias_options", []),
                                    example[models.FRAME_IMG].shape[1:])
        tx = training.make_optimizer(train_settings.optimizer, base_lr)

        total_nets = len(folds) * num_nets
        if devices is not None:
            device = devices[0]
            if len(devices) < 2 or total_nets % len(devices) != 0:
                devices = None
        state = training.init_ensemble(model, example, total_nets, tx, device=device)

        # Per-fold learning rates through lr_scale, so a learning-rate sweep
        # shares one program.
        lr_scale = np.ones((total_nets,), np.float32)
        for f, settings in enumerate(folds):
            lr_scale[f * num_nets : (f + 1) * num_nets] = (
                float(settings.get("learning_rate", base_lr)) / base_lr
            )
        state = state._replace(lr_scale=torch.as_tensor(lr_scale, device=device))

        if preload_dir:
            restored = []
            for settings in folds:
                full = os.path.join(preload_dir, settings["settings_id"])
                restored.extend(data_lib.preload_model_names(full, num_nets))
            loaded = training.load_ensemble_params(restored)
            params, batch_stats = convert.ensemble_from_flax(
                loaded["params"], loaded["batch_stats"], device)
            state = state._replace(params=params, batch_stats=batch_stats)

        mags = np.mean(
            np.abs(
                train_data[label_name].reshape(train_data[label_name].shape[0], -1)
            ),
            axis=1,
        )
        weighters = []
        net_out_specs = []
        for settings in folds:
            sid = settings["settings_id"]
            os.makedirs(os.path.join(out_root, sid), exist_ok=True)
            os.makedirs(os.path.join(log_root, sid), exist_ok=True)
            for n in range(num_nets):
                weighters.append(
                    weighting.make_sample_weighter(
                        settings.get(
                            "sample_weighter_options", {"name": "uniform"}
                        ),
                        mags,
                    )
                )
                net_out_specs.append((os.path.join(out_root, sid), n))

    events = training.train_models(
        model, state, tx, train_data, val_data,
        input_names=input_names, label_name=label_name, weighters=weighters,
        settings=train_settings, out_dir=out_root, print_log=False,
        net_out_specs=net_out_specs, devices=devices,
    )

    with profiling.stage("search.fold_logs"):
        # Per-fold scalar logs: the super-ensemble's curves sliced apart.
        for f, settings in enumerate(folds):
            sid = settings["settings_id"]
            path = os.path.join(log_root, sid, "train_log.jsonl")
            with open(path, "a") as log_file:
                for event in events:
                    lo, hi = f * num_nets, (f + 1) * num_nets
                    train_per_net = (event.train_loss_per_net or [])[lo:hi]
                    val_per_net = (event.val_loss_per_net or [])[lo:hi]
                    log_file.write(
                        json.dumps(
                            {
                                "epoch": event.epoch,
                                "train_loss": float(np.mean(train_per_net))
                                if train_per_net
                                else event.train_loss,
                                "val_loss": float(np.mean(val_per_net))
                                if val_per_net
                                else event.val_loss,
                                "epoch_duration_sec": event.epoch_duration_sec,
                                "examples_per_sec": event.examples_per_sec,
                                "train_loss_per_net": train_per_net,
                                "val_loss_per_net": val_per_net,
                            }
                        )
                        + "\n"
                    )


def search_devices(device):
    """The devices a group may spread over: every visible card on CUDA, the
    one CPU device on the CPU."""
    if device.type != "cuda":
        return [device]
    from pilotguru_tpu_torch.parallel.mesh import cuda_devices

    return cuda_devices()


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--data_dirs", required=True)
    parser.add_argument("--validation_data_dirs", required=True)
    parser.add_argument("--data_file_suffix", default="data.npz")
    parser.add_argument("--train_settings_json_glob", required=True)
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--preload_dir", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--log_dir", required=True)
    parser.add_argument("--parallelism", type=int, default=1)  # ignored
    parser.add_argument("--num_nets_to_train", type=int, default=1)
    parser.add_argument("--batch_use_prob", type=float, default=1.0)
    parser.add_argument("--cuda_device_ids", default="0")  # ignored
    add_dtype_flag(parser)
    args = parser.parse_args(argv)
    device, _ = setup_device(args.dtype)
    devices = search_devices(device)

    from pilotguru_tpu_torch.ml import data as data_lib

    settings_list = []
    for pattern in args.train_settings_json_glob.split(","):
        for name in sorted(glob.glob(pattern)):
            with open(name) as f:
                settings_list.append(json.load(f))
    if not settings_list:
        parser.error("no settings files matched --train_settings_json_glob")

    first = settings_list[0]
    element_names = first["input_names"] + first["label_names"]
    train_data = data_lib.load_dataset(
        args.data_dirs.split(","), element_names, args.data_file_suffix
    )
    val_data = data_lib.load_dataset(
        args.validation_data_dirs.split(","), element_names, args.data_file_suffix
    )

    for folds in group_folds(settings_list):
        run_training_group(
            folds,
            train_data,
            val_data,
            epochs=args.epochs,
            num_nets=args.num_nets_to_train,
            batch_use_prob=args.batch_use_prob,
            out_root=args.out_dir,
            log_root=args.log_dir,
            preload_dir=args.preload_dir,
            devices=devices,
        )
        for settings in folds:
            print(settings["settings_id"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
