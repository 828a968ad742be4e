"""train CLI: steering-model ensemble training on npz datasets.

Flag-compatible with pilotguru_tpu.cli.train (the reference's
python/train.py), the JSON-encoded nested settings flags included
(--net_options, --linear_bias_options, --sample_weighter_options).
Checkpoints are the JAX package's flax msgpack files with the reference's
stem (model-{i}-{best,last}.msgpack); --base_preload_dir reads them;
--cuda_device_id is accepted and ignored, as in the JAX CLI. The
--num_nets_to_train nets train as one program (ml/training.py), with the
augmentation on the device inside the step.

The device comes from PILOTGURU_TPU_PLATFORM (cpu | cuda, default cuda; a
cuda request without a card raises). One flag is the port's own:
--compute_dtype (float32 | bfloat16) sets the convolutions' and dense
layers' precision; unset, bfloat16 on CUDA and float32 on the CPU, as the
JAX package's default gives its accelerator.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from pilotguru_tpu_torch.cli._common import make_parser, setup_device


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--data_dirs", required=True)
    parser.add_argument("--validation_data_dirs", required=True)
    parser.add_argument("--data_file_suffix", default="data.npz")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--batch_use_prob", type=float, default=1.0)
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--optimizer", default="sgd")
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--loss_norm_pow", type=float, default=2.0)
    parser.add_argument("--plateau_patience_epochs", type=int, default=0)
    parser.add_argument("--in_channels", type=int, default=3)
    parser.add_argument("--target_height", type=int, required=True)
    parser.add_argument("--target_width", type=int, required=True)
    parser.add_argument("--net_name", default="nvidia")
    parser.add_argument("--net_input_names", default="frame_img,forward_axis")
    parser.add_argument("--net_label_names", default="steering")
    parser.add_argument("--net_head_dims", type=int, default=10)
    parser.add_argument(
        "--linear_bias_options",
        default=json.dumps([{"input_name": "forward_axis", "input_dims": 3}]),
    )
    parser.add_argument("--num_nets_to_train", type=int, default=1)
    parser.add_argument(
        "--net_options",
        default=json.dumps(
            {
                "conv": {"batchnorm": True, "activation": "relu", "dropout": "2d"},
                "fc": {"batchnorm": True, "activation": "relu", "dropout": "vanilla"},
            }
        ),
    )
    parser.add_argument("--label_dimensions", type=int, default=1)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--log_dir", default="")
    parser.add_argument("--base_preload_dir", default=None)
    parser.add_argument("--dropout_prob", type=float, default=0.0)
    parser.add_argument("--max_horizontal_shift_pixels", type=int, default=0)
    parser.add_argument("--horizontal_label_shift_rate", default="0.0")
    parser.add_argument("--train_blur_sigma", type=float, default=2.0)
    parser.add_argument("--train_blur_prob", type=float, default=0.0)
    parser.add_argument("--do_pca_random_shifts", type=bool, default=False)
    parser.add_argument("--grayscale_interpolate_prob", type=float, default=0.0)
    parser.add_argument(
        "--sample_weighter_options", default=json.dumps({"name": "uniform"})
    )
    parser.add_argument("--dry_run", type=bool, default=False)
    parser.add_argument("--settings_id", default="")
    parser.add_argument("--cuda_device_id", type=int, default=0)  # ignored
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", choices=["", "float32", "bfloat16"], default="")
    args = parser.parse_args(argv)

    from pilotguru_tpu_torch.ml import augmentation as aug
    from pilotguru_tpu_torch.ml import convert
    from pilotguru_tpu_torch.ml import data as data_lib
    from pilotguru_tpu_torch.ml import models, training, weighting

    input_names = args.net_input_names.split(",")
    label_names = args.net_label_names.split(",")
    if len(label_names) != 1:
        parser.error("exactly one label name is supported")
    label_name = label_names[0]

    options = {
        models.NET_NAME: args.net_name,
        models.NET_HEAD_DIMS: args.net_head_dims,
        models.LABEL_DIMENSIONS: args.label_dimensions,
        models.DROPOUT_PROB: args.dropout_prob,
        models.LAYER_BLOCKS_OPTIONS: json.loads(args.net_options),
    }
    bias_options = json.loads(args.linear_bias_options)
    shift_rate = tuple(
        float(x) for x in args.horizontal_label_shift_rate.split(",")
    )

    if args.dry_run:
        print(json.dumps(options, indent=2, sort_keys=True))
        return 0
    if args.compute_dtype:
        options[models.COMPUTE_DTYPE] = args.compute_dtype
    device, _ = setup_device()

    element_names = input_names + label_names
    train_data = data_lib.load_dataset(
        args.data_dirs.split(","), element_names, args.data_file_suffix
    )
    val_data = data_lib.load_dataset(
        args.validation_data_dirs.split(","), element_names, args.data_file_suffix
    )

    shift_dirs = None
    if args.do_pca_random_shifts:
        shift_dirs = aug.pca_rgb_directions(
            data_lib.images_to_float(train_data[models.FRAME_IMG])
        )

    settings = training.TrainSettings(
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        loss_norm_pow=args.loss_norm_pow,
        batch_use_prob=args.batch_use_prob,
        plateau_patience_epochs=args.plateau_patience_epochs,
        augment=aug.AugmentSettings(
            target_width=args.target_width,
            max_horizontal_shift_pixels=args.max_horizontal_shift_pixels,
            horizontal_label_shift_rate=shift_rate,
            blur_sigma=args.train_blur_sigma,
            blur_prob=args.train_blur_prob,
            grayscale_interpolate_prob=args.grayscale_interpolate_prob,
            random_shift_directions=shift_dirs,
        ),
        seed=args.seed,
    )

    example = {}
    for name in input_names:
        arr = train_data[name][:1]
        if name == models.FRAME_IMG:
            arr = data_lib.images_to_float(arr)
            arr = np.asarray(arr[:, :, : args.target_width])  # width crop shape
            arr = arr[:, : args.target_height]
        example[name] = np.asarray(arr, np.float32)
    model = models.make_network(options, bias_options, example[models.FRAME_IMG].shape[1:])
    tx = training.make_optimizer(settings.optimizer, settings.learning_rate)
    state = training.init_ensemble(
        model, example, args.num_nets_to_train, tx, seed=args.seed, device=device
    )

    if args.base_preload_dir:
        paths = data_lib.preload_model_names(
            args.base_preload_dir, args.num_nets_to_train
        )
        restored = training.load_ensemble_params(paths)
        params, batch_stats = convert.ensemble_from_flax(
            restored["params"], restored["batch_stats"], device)
        state = state._replace(params=params, batch_stats=batch_stats)

    steering_mags = np.mean(
        np.abs(train_data[label_name].reshape(train_data[label_name].shape[0], -1)),
        axis=1,
    )
    weighters = [
        weighting.make_sample_weighter(
            json.loads(args.sample_weighter_options), steering_mags
        )
        for _ in range(args.num_nets_to_train)
    ]

    training.train_models(
        model,
        state,
        tx,
        train_data,
        val_data,
        input_names=input_names,
        label_name=label_name,
        weighters=weighters,
        settings=settings,
        out_dir=args.out_dir,
        # Scalars always persist: --log_dir if given, else next to the
        # checkpoints.
        log_path=os.path.join(args.log_dir or args.out_dir, "train_log.jsonl"),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
