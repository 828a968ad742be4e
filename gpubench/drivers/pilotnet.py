"""Traffic driver ``pilotnet``: PilotNet ensembles trained through the port's
training loop, ``pilotguru_tpu_torch.ml.training.train_models``, as the
``train`` CLI calls it (``job: train``) or as ``hyperparams_search`` trains
one group of folds stacked into a super-ensemble (``job: search``, through
``run_training_group``).

The data (uint8 frames, the forward axis, steering labels) and the initial
weights are made from the seed on the device. Set-up runs one warm-up epoch
on a throwaway copy of the initial state. The window is one job of a fixed
size: ``ceil(seconds / epoch_seconds)`` whole epochs, validation and
checkpoints included, where ``epoch_seconds`` (the traffic file's) makes
the window last about the run's seconds today; both sides of a comparison
train the same epochs. The harness
records what the first three train steps returned (a wrapper around the
program's step that keeps references to its outputs and changes nothing),
and the plain reference repeats those three steps from the same initial
weights on the same rows.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from gpubench.devtrace import DeviceTrace, Spans
from gpubench.reference import pilotnet, plain_float32

CHECKED_STEPS = 3


def make_data(cfg: dict, count: int, generator, device):
    """``count`` examples drawn from ``generator`` on the device, as host
    arrays: uint8 frames, the forward axis and the steering labels."""
    import torch

    h, w, c = cfg["input_shape"]
    frames = torch.randint(0, 256, (count, h, w, c), dtype=torch.uint8, generator=generator,
                           device=device)
    axis = torch.randn((count, cfg["bias_input_dims"]), generator=generator, device=device)
    labels = 0.1 * torch.randn((count, cfg["labels_per_example"]), generator=generator,
                               device=device)
    return {"frame_img": frames.cpu().numpy(), cfg["bias_input"]: axis.cpu().numpy(),
            "steering": labels.cpu().numpy()}


def nested(flat: dict) -> dict:
    out: dict = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


class StepRecorder:
    """Wraps ``training.make_train_step`` for the run: keeps the states and
    losses the first ``CHECKED_STEPS`` steps return, counts steps and
    records each step's host span."""

    def __init__(self, training, spans: Spans):
        self.training, self.spans = training, spans
        self.original = training.make_train_step
        self.steps, self.recorded, self.armed = 0, [], False

    def __enter__(self):
        original, recorder = self.original, self

        def make_train_step(*args, **kwargs):
            step = original(*args, **kwargs)

            def recorded_step(*a, **k):
                start = time.time_ns()
                out = step(*a, **k)
                recorder.spans.add("train step call", start, time.time_ns())
                if recorder.armed:
                    recorder.steps += 1
                    if len(recorder.recorded) < CHECKED_STEPS:
                        recorder.recorded.append(out)
                return out

            return recorded_step

        self.training.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        self.training.make_train_step = self.original


def _settings(cfg, lr):
    return {
        "settings_id": f"lr{lr:g}", "net_name": cfg["net_name"],
        "input_names": ["frame_img", cfg["bias_input"]], "label_names": ["steering"],
        "target_height": cfg["input_shape"][0], "target_width": cfg["input_shape"][1],
        "net_head_dims": cfg["head_dims"], "label_dimensions": cfg["label_dimensions"],
        "dropout_prob": 0.0,
        "layer_blocks_options": {"conv": {"batchnorm": True, "activation": "relu",
                                          "dropout": "2d"},
                                 "fc": {"batchnorm": True, "activation": "relu",
                                        "dropout": "vanilla"}},
        "linear_bias_options": [{"input_name": cfg["bias_input"],
                                 "input_dims": cfg["bias_input_dims"]}],
        "optimizer": cfg["optimizer"], "learning_rate": lr, "batch_size": cfg["batch_size"],
        "compute_dtype": cfg["dtype"],
    }


class TrainJob:
    """``train``: one ensemble of ``nets`` nets, as cli/train.py builds it."""

    def __init__(self, cfg, trf, seed, device, params, out_root):
        from pilotguru_tpu_torch.ml import augmentation, models, training

        self.training = training
        s = _settings(cfg, trf["learning_rates"][0])
        options = {models.NET_NAME: s["net_name"], models.NET_HEAD_DIMS: s["net_head_dims"],
                   models.LABEL_DIMENSIONS: s["label_dimensions"], models.DROPOUT_PROB: 0.0,
                   models.LAYER_BLOCKS_OPTIONS: s["layer_blocks_options"],
                   models.COMPUTE_DTYPE: s["compute_dtype"]}
        self.model = models.make_network(options, s["linear_bias_options"],
                                         tuple(cfg["input_shape"]))
        self.tx = training.make_optimizer(s["optimizer"], s["learning_rate"])
        self.settings = s
        self.seed, self.device, self.params = seed, device, params
        self.augment = augmentation.AugmentSettings(target_width=s["target_width"])
        self.nets = trf["nets"]
        self.out_root = out_root
        self.lr_scale = [1.0] * self.nets
        self.base_lr = s["learning_rate"]
        self.train_seed = seed

    def state(self, example):
        state = self.training.init_ensemble(self.model, example, self.nets, self.tx,
                                            seed=self.seed, device=self.device)
        return state._replace(params=nested({k: v.clone() for k, v in self.params.items()}))

    def prepare(self, train, val, epochs, tag):
        """The train CLI's set-up (its model, state and weighters), then a
        call that trains: returns each epoch's per-net train losses."""
        from pilotguru_tpu_torch.ml import weighting

        example = {k: v[:1].astype(np.float32) / (255.0 if k == "frame_img" else 1.0)
                   for k, v in train.items() if k != "steering"}
        mags = np.mean(np.abs(train["steering"]), axis=1)
        weighters = [weighting.make_sample_weighter({"name": "uniform"}, mags)
                     for _ in range(self.nets)]
        settings = self.training.TrainSettings(
            epochs=epochs, batch_size=self.settings["batch_size"],
            learning_rate=self.base_lr, optimizer=self.settings["optimizer"],
            augment=self.augment, seed=self.train_seed)
        out = os.path.join(self.out_root, tag)
        state = self.state(example)

        def train_call():
            log = self.training.train_models(
                self.model, state, self.tx, train, val,
                input_names=self.settings["input_names"], label_name="steering",
                weighters=weighters, settings=settings, out_dir=out, print_log=False,
                log_path=os.path.join(out, "train_log.jsonl"))
            return [e.train_loss_per_net for e in log]

        return train_call


class SearchJob:
    """``search``: one fold per learning rate, each of ``nets`` nets, stacked
    into one super-ensemble by hyperparams_search's grouping."""

    def __init__(self, cfg, trf, seed, device, params, out_root):
        import torch

        from pilotguru_tpu_torch.cli import hyperparams_search
        from pilotguru_tpu_torch.ml import training

        self.training, self.search = training, hyperparams_search
        self.folds = [_settings(cfg, lr) for lr in trf["learning_rates"]]
        groups = hyperparams_search.group_folds(self.folds)
        if len(groups) != 1:
            raise ValueError(f"the search's folds make {len(groups)} groups, want one")
        self.nets, self.device, self.out_root = trf["nets"], device, out_root
        self.base_lr = float(self.folds[0]["learning_rate"])
        self.lr_scale = [f["learning_rate"] / self.base_lr
                         for f in self.folds for _ in range(self.nets)]
        self.train_seed = 0  # the search trains with TrainSettings' default seed
        # The seed's initial weights reach the group through --preload_dir's
        # files, one per net in each fold's directory.
        self.preload = os.path.join(out_root, "preload")
        total = len(self.folds) * self.nets
        tree = nested(params)
        batch_stats = {}
        for name, value in params.items():
            if name.endswith("BatchNorm_0/scale"):
                base = name[: -len("scale")]
                batch_stats[base + "mean"] = torch.zeros_like(value)
                batch_stats[base + "var"] = torch.ones_like(value)
        state = training.EnsembleState(tree, nested(batch_stats), {},
                                       torch.ones(total, device=device))
        for f, settings in enumerate(self.folds):
            for n in range(self.nets):
                training.save_net(state, f * self.nets + n, os.path.join(
                    self.preload, settings["settings_id"], f"model-{n}-last.msgpack"))

    def prepare(self, train, val, epochs, tag):
        """A call that trains the group as hyperparams_search does (its
        set-up is inside): returns each epoch's per-net train losses."""
        import torch

        out = os.path.join(self.out_root, tag)

        def train_call():
            self.search.run_training_group(
                self.folds, train, val, epochs=epochs, num_nets=self.nets,
                batch_use_prob=1.0, out_root=os.path.join(out, "models"),
                log_root=os.path.join(out, "logs"), preload_dir=self.preload,
                device=self.device,
                devices=self.search.search_devices(torch.device(self.device)))
            losses = []
            for settings in self.folds:
                path = os.path.join(out, "logs", settings["settings_id"], "train_log.jsonl")
                with open(path) as f:
                    losses.append([json.loads(line)["train_loss_per_net"] for line in f])
            return [sum((fold[e] for fold in losses), []) for e in range(len(losses[0]))]

        return train_call


JOBS = {"train": TrainJob, "search": SearchJob}


def leaf_gap(prog: dict, ref: dict, keep=None):
    """Worst (leaf, net) gap between the program's and the reference's
    norms, against the reference's norm of that leaf or the median leaf's,
    whichever is larger; over the leaves ``keep`` lets through."""
    norms = {}
    for name, r in ref.items():
        for n in range(r.shape[0]):
            norms[(name, n)] = (float(prog[name][n].double().norm()),
                                float(r[n].double().norm()))
    median = float(np.median([b for _, b in norms.values()]))
    gaps = {key: abs(a - b) / max(b, median) for key, (a, b) in norms.items()
            if keep is None or keep(key)}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], norms, worst


def check_steps(cfg, job, train, initial, recorded, device):
    """The first three steps' losses, the first gradient (the SGD trace after
    one step: the gradient itself) and the parameters' change after the
    three, program against the plain reference."""
    import torch

    batch = cfg["batch_size"]
    order = np.random.default_rng(job.train_seed).permutation(len(train["steering"]))
    batches = []
    for k in range(len(recorded)):
        idx = order[k * batch:(k + 1) * batch]
        batches.append((torch.as_tensor(train["frame_img"][idx], device=device),
                        torch.as_tensor(train[cfg["bias_input"]][idx], device=device),
                        torch.as_tensor(train["steering"][idx], device=device)))
    ref = {}

    def on_step(k, losses, grads, params):
        ref[k] = (losses, grads if k == 0 else None, params)

    pilotnet.sgd_steps(cfg, initial, batches, job.base_lr, job.lr_scale, on_step)
    loss_gap = 0.0
    for k, (state, losses, _) in enumerate(recorded):
        r = ref[k][0].double()
        loss_gap = max(loss_gap, float(((losses.double() - r).abs() / r.abs()).max()))
    grad_prog = flatten(recorded[0][0].opt_state["trace"])
    grad_gap, grad_norms, grad_worst = leaf_gap(grad_prog, ref[0][1])
    median_grad = float(np.median([b for _, b in grad_norms.values()]))
    moved = {key for key, (_, b) in grad_norms.items() if b >= 1e-3 * median_grad}
    last = len(recorded) - 1
    change_prog = {k: v - initial[k] for k, v in flatten(recorded[last][0].params).items()}
    change_ref = {k: v - initial[k] for k, v in ref[last][2].items()}
    change_gap, _, change_worst = leaf_gap(change_prog, change_ref,
                                           keep=lambda key: key in moved)
    worst = {"first_gradient": grad_worst, "change": change_worst}
    return ({"step_loss_gap": loss_gap, "first_gradient_gap": grad_gap,
             "change_gap": change_gap}, len(grad_norms) - len(moved), worst)


def run(r):
    import torch

    from gpubench.harness import Check, Outcome
    from pilotguru_tpu_torch.ml import training

    cfg, trf, cell = r.config, r.traffic, r.cell
    device = torch.device(r.device)
    generator = torch.Generator(device=device).manual_seed(r.seed)
    train = make_data(cfg, trf["train_examples"], generator, device)
    val = make_data(cfg, trf["val_examples"], generator, device)
    total_nets = trf["nets"] * len(trf["learning_rates"])
    initial = pilotnet.initial_params(cfg, total_nets, r.seed, device)
    job = JOBS[trf["job"]](cfg, trf, r.seed, device, initial, r.out_root)
    spans = Spans()

    with StepRecorder(training, spans) as recorder:
        start = time.perf_counter()
        job.prepare(train, val, 1, "warmup")()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        warm_s = time.perf_counter() - start
        epochs = max(1, math.ceil(r.seconds / trf["epoch_seconds"]))
        train_call = job.prepare(train, val, epochs, "window")
        recorder.armed = True
        trace = DeviceTrace() if r.trace else None
        if trace is not None:
            trace.start()
        t0 = time.perf_counter()
        setup_s = time.time() - r.t_start
        losses = train_call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        if trace is not None:
            trace.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = trace.summary(spans, "training loop outside the step") if trace else None

    net_examples = epochs * trf["train_examples"] * total_nets
    with plain_float32():
        gaps, unmoved, worst = check_steps(cfg, job, train, initial, recorder.recorded,
                                           device)
    limits = cell["limits"]
    checks = [Check(name, value, limits[name]) for name, value in gaps.items()]
    failed = sum(1 for epoch in losses for loss in epoch if not math.isfinite(loss))
    layer = {"train": {"steps": recorder.steps, "window_s": window_s,
                       "net_examples": net_examples, "trace": summary,
                       "flops_per_net_example": 3 * pilotnet.forward_flops(cfg)}}
    return Outcome(
        attempted=epochs * total_nets, failed=failed,
        end_to_end={"train_net_examples_per_s": (net_examples / window_s, "net-examples/s"),
                    "setup_s": (setup_s, "s")},
        layer=layer, checks=checks, memory_peak_bytes=peak, trace=summary,
        notes={"epochs": epochs, "warmup_epoch_s": warm_s, "window_s": window_s,
               "steps": recorder.steps, "leaves_left_out_of_change": unmoved,
               "worst_leaves": {k: f"{name}[{n}]" for k, (name, n) in worst.items()}})
