"""Traffic driver ``rambo``: a Udacity Rambo ensemble trained through the
port's training loop, ``pilotguru_tpu_torch.ml.training.train_models``, as
the ``train`` CLI calls it (``job: train``), and held to the plain
reference ``reference/rambo.py``.

Everything but the net is drivers/pilotnet.py's train job: the data and
initial weights from the seed on the device, one warm-up epoch on a
throwaway copy of the state as set-up, a window of ``ceil(seconds /
epoch_seconds)`` whole epochs, and the first three train steps repeated by
the reference from the same weights on the same rows. A ``--trace 1`` run
also records the port's spans and tallies over the window
(``idle.RecordingTrace``) and puts them in the layer's readings: the
tallies (``folded.bn_fused`` counts the fused batch norm's calls on the
card), the ``train.step`` spans, and the bytes the fused batch norm pair
must move a step, counted from the configuration's layer shapes.
"""

from __future__ import annotations

import math
import time

import numpy as np

from gpubench.devtrace import Spans
from gpubench.drivers.pilotnet import (
    StepRecorder,
    TrainJob,
    flatten,
    leaf_gap,
    make_data,
)
from gpubench.idle import RecordingTrace
from gpubench.reference import plain_float32, rambo

ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def bn_relu_bytes_per_step(cfg: dict, nets: int) -> int:
    """The bytes the fused batch norm + ReLU pair must move a train step: at
    every train-mode batch norm of every net, the activation x and its
    upstream gradient read once, y and dx written once, in the compute
    dtype."""
    values = sum(size for _, size, _ in rambo.batch_norm_sizes(cfg))
    return 4 * ITEM_BYTES[cfg["dtype"]] * cfg["batch_size"] * nets * values


def check_steps(cfg, job, train, initial, recorded, device):
    """drivers/pilotnet.py's check against reference/rambo.py: the first
    three steps' losses, the first gradient and the parameters' change
    after the three."""
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

    rambo.sgd_steps(cfg, initial, batches, job.base_lr, job.lr_scale, on_step)
    loss_gap = 0.0
    for k, (_, losses, _) in enumerate(recorded):
        r = ref[k][0].double()
        loss_gap = max(loss_gap, float(((losses.double() - r).abs() / r.abs()).max()))
    grad_gap, grad_norms, grad_worst = leaf_gap(flatten(recorded[0][0].opt_state["trace"]),
                                                ref[0][1])
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
    if trf["job"] != "train":
        raise ValueError(f"the rambo driver runs the train job, not {trf['job']!r}")
    device = torch.device(r.device)
    generator = torch.Generator(device=device).manual_seed(r.seed)
    train = make_data(cfg, trf["train_examples"], generator, device)
    val = make_data(cfg, trf["val_examples"], generator, device)
    nets = trf["nets"]
    initial = rambo.initial_params(cfg, nets, r.seed, device)
    job = TrainJob(cfg, trf, r.seed, device, initial, r.out_root)
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
        trace = RecordingTrace() if r.trace else None
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

    net_examples = epochs * trf["train_examples"] * nets
    with plain_float32():
        gaps, unmoved, worst = check_steps(cfg, job, train, initial, recorder.recorded,
                                           device)
    limits = cell["limits"]
    checks = [Check(name, value, limits[name]) for name, value in gaps.items()]
    failed = sum(1 for epoch in losses for loss in epoch if not math.isfinite(loss))
    layer = {"train": {"steps": recorder.steps, "window_s": window_s,
                       "net_examples": net_examples, "trace": summary,
                       "flops_per_net_example": 3 * rambo.forward_flops(cfg)}}
    if trace is not None:
        layer["train"].update(
            tallies=dict(trace.timer.tallies),
            step_spans=[(s.start_ns, s.end_ns) for s in trace.timer.spans
                        if s.name == "train.step"],
            bn_relu_bytes_per_step=bn_relu_bytes_per_step(cfg, nets))
    notes = {"epochs": epochs, "warmup_epoch_s": warm_s, "window_s": window_s,
             "steps": recorder.steps, "leaves_left_out_of_change": unmoved,
             "worst_leaves": {k: f"{name}[{n}]" for k, (name, n) in worst.items()}}
    if trace is not None:
        notes["tallies"] = layer["train"]["tallies"]
    return Outcome(
        attempted=epochs * nets, failed=failed,
        end_to_end={"train_net_examples_per_s": (net_examples / window_s, "net-examples/s"),
                    "setup_s": (setup_s, "s")},
        layer=layer, checks=checks, memory_peak_bytes=peak, trace=summary, notes=notes)
