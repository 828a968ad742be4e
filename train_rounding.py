"""How far float32 rounding moves PilotNet x3 training on chip_smoke's road
dataset (PERF.md §6).

    python3 train_rounding.py [--gradients] [--threads] [--root DIR]

Writes the road ride and its dataset (chip_smoke.write_road_ride,
make_steering_dataset on the CPU) under --root, unless they are there, then:

--gradients: the train CLI's first step (its init, the dataset's first 64
    examples, the folded forward in train mode) as gradients in float32 on
    the CPU and, where a card is present, on the card (cuDNN as it stands,
    cuDNN deterministic, cuDNN off), each against the same gradients in
    float64 on the CPU: per leaf, the largest difference over the leaf's
    largest float64 gradient, the four worst leaves (biases just before
    batch norm, whose gradients are rounding noise, left out).
--threads: the train CLI as chip_smoke runs it (TRAIN: SGD, batch 64, 3
    epochs, --batch_use_prob=0.7, exp_recent_loss) on the CPU twice in
    float32, with 1 and with 4 threads (the same sums in another order),
    and chip_smoke.compare_training's distance between the two runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke

NAMES = ["frame_img", "forward_axis", "steering"]


def dataset(root) -> str:
    data_dir = os.path.join(root, "data")
    if not os.path.isdir(data_dir):
        from pilotguru_tpu_torch.cli import make_steering_dataset

        paths = chip_smoke.write_road_ride(os.path.join(root, "road"))
        with chip_smoke._platform("cpu"):
            if make_steering_dataset.main(chip_smoke.dataset_argv(paths, data_dir)) != 0:
                raise SystemExit("make_steering_dataset failed")
    return data_dir


def _pre_norm_bias(name) -> bool:
    return name.endswith("Conv_0/bias") or (name.startswith("FcBlock_")
                                            and name.endswith("Dense_0/bias"))


def gradients(data_dir) -> dict:
    from pilotguru_tpu_torch.ml import convert, data, folded, models, training

    d = data.load_dataset([data_dir], NAMES)
    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 2,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    state = training.init_ensemble(model, {}, 3, training.make_optimizer("sgd", 0.01))
    b = chip_smoke.TRAIN["batch"]

    def grads(device, dtype=torch.float32):
        params = convert.tree_map(lambda t: t.to(device, dtype).requires_grad_(), state.params)
        stats = convert.tree_map(lambda t: t.to(device, dtype), state.batch_stats)
        x = {"frame_img": torch.as_tensor(d["frame_img"][:b]).to(device).to(dtype) / 255,
             "forward_axis": torch.as_tensor(d["forward_axis"][:b]).to(device, dtype)}
        saved = models.resolve_compute_dtype
        models.resolve_compute_dtype = lambda options, device: dtype
        try:
            out, _ = folded.folded_forward(model, params, stats, x, True)
        finally:
            models.resolve_compute_dtype = saved
        labels = torch.as_tensor(d["steering"][:b]).to(device, dtype)
        loss = training.power_loss(out.to(dtype), labels, 2.0).mean(1).sum()
        leaves = list(training._leaves(params))
        g = iter(torch.autograd.grad(loss, leaves))
        return chip_smoke._flat_tree(
            convert.tree_map(lambda _: next(g).detach().cpu().double().numpy(), params))

    reference = grads("cpu", torch.float64)
    runs = {"cpu float32": lambda: grads("cpu")}
    if torch.cuda.is_available():
        def card(deterministic, enabled):
            def run():
                torch.backends.cudnn.deterministic = deterministic
                torch.backends.cudnn.enabled = enabled
                try:
                    return grads("cuda")
                finally:
                    torch.backends.cudnn.deterministic = False
                    torch.backends.cudnn.enabled = True
            return run
        runs.update({"card float32": card(False, True),
                     "card float32, cudnn deterministic": card(True, True),
                     "card float32, cudnn off": card(False, False)})
    out = {}
    for name, run in runs.items():
        g = run()
        errors = {k: float(np.abs(g[k] - v).max() / np.abs(v).max())
                  for k, v in reference.items() if not _pre_norm_bias(k)}
        out[name] = sorted(errors.items(), key=lambda kv: -kv[1])[:4]
        print(f"first step's gradients, {name} against cpu float64: {json.dumps(out[name])}",
              flush=True)
    return out


THREADS_CHILD = """
import sys, torch
torch.set_num_threads(int(sys.argv[1]))
import chip_smoke
from pilotguru_tpu_torch.cli import train
sys.exit(train.main(chip_smoke.train_argv(sys.argv[2], sys.argv[3], "float32")))
"""


def threads(data_dir, root) -> dict:
    outs = {}
    for n in (1, 4):
        outs[n] = os.path.join(root, f"train-{n}-threads")
        env = dict(os.environ, PILOTGURU_TPU_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, "-c", THREADS_CHILD, str(n), data_dir, outs[n]],
                       env=env, check=True, stdout=subprocess.DEVNULL)
    row = chip_smoke.compare_training(outs[1], outs[4])
    row.pop("checkpoints")
    print(f"train CLI on the CPU in float32, 1 thread against 4: {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gradients", action="store_true")
    parser.add_argument("--threads", action="store_true")
    parser.add_argument("--root", default=None)
    args = parser.parse_args()
    root = args.root or tempfile.mkdtemp(prefix="pg_train_rounding_")
    data_dir = dataset(root)
    if args.gradients:
        gradients(data_dir)
    if args.threads:
        threads(data_dir, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
