"""Ensemble steering-model training and checkpoints (port of
pilotguru_tpu/ml/training.py, itself the reference's python/optimize.py and
training_helpers.py).

N nets train as one program a batch: their parameters are stacked ``[N,
...]`` tensors in the flax tree's names and layouts (``EnsembleState``), so
checkpoints and ``ml/convert.py`` carry them across to the JAX package.
PilotNet and the Udacity Rambo net run folded (``ml/folded.py``); the other
nets run one after another through ``torch.func.functional_call`` on the
same stacked tensors.
Augmentation runs on the device inside the step (``ml/augmentation.py``).

Semantics kept from the JAX package:
  - PowerLoss |pred - label|^p averaged over non-batch dims;
  - per-example weights from the weighters, loss mean(per_example * w);
  - per-net Bernoulli batch skipping (--batch_use_prob): a skipped net keeps
    its parameters, batch statistics and optimizer state, Adam's count
    included;
  - SGD (optax's trace with momentum 0.9, then -lr) and Adam (optax's: b1
    0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction by the count),
    written out as functions of the stacked tensors with one step count per
    net (``torch.optim`` shares one count across a stacked tensor);
  - each net's update times its ``lr_scale`` (the plateau halving and the
    grid search's per-fold learning rates);
  - best/last checkpoints per net, the console epoch lines with ``***`` /
    ``*`` markers and train_log.jsonl with the JAX package's keys.

Repeatability: the training loop runs with cuDNN's deterministic
algorithms (``_deterministic_cudnn``). Its default backward-filter
algorithms may add with atomics, in whatever order the threads arrive, and
this training amplifies rounding, so a run on the card would not repeat.
The folded path's float32 conv backward on the card is hand-written
(ml/conv_kernel.py) and sums in an order fixed by the shape.

Randomness: the host's ``np.random.default_rng(seed)`` draws each epoch's
permutation and each batch's skip mask in the JAX package's order, so the
batches and the skipped nets are the same. The device's draws
(augmentation, dropout) come from a ``torch.Generator`` seeded with
``seed + 1`` where the JAX package uses a ``PRNGKey``: those draws differ
from the JAX package's, and so does the parameter init (flax's
initializers, drawn from a ``torch.Generator`` seeded with ``seed``).

A checkpoint is the JAX package's file: flax's msgpack of {"params": ...,
"batch_stats": ...} for one net, written and read by the port's own codec
(utils/msgpack.py); a file the port writes loads in the JAX package's
``training.load_net`` and the other way round.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from pilotguru_tpu_torch.ml import convert, folded
from pilotguru_tpu_torch.ml import data as data_lib
from pilotguru_tpu_torch.ml import models as models_lib
from pilotguru_tpu_torch.ml import staging as staging_lib
from pilotguru_tpu_torch.ml.augmentation import (
    AugmentSettings,
    augment_batch,
    center_crop_width,
    draw_augmentation,
)
from pilotguru_tpu_torch.ml.convert import tree_map
from pilotguru_tpu_torch.parallel.mesh import (
    block_bounds,
    gather_leading_axis,
    make_mesh,
    shard_leading_axis,
)
from pilotguru_tpu_torch.utils import msgpack, profiling

ADAM = "adam"
SGD = "sgd"


class EnsembleState(NamedTuple):
    params: Dict  # flax tree of [N, ...] float32 tensors
    batch_stats: Dict  # flax tree of [N, ...] float32 tensors (may be empty)
    opt_state: Dict  # the optimizer's trees of [N, ...] tensors (see Sgd, Adam)
    lr_scale: torch.Tensor  # [N] multiplicative LR factors (plateau scheduler)


@dataclass
class TrainSettings:
    epochs: int
    batch_size: int
    learning_rate: float = 1e-3
    optimizer: str = SGD
    loss_norm_pow: float = 2.0
    batch_use_prob: float = 1.0
    plateau_patience_epochs: int = 0
    augment: AugmentSettings = field(default_factory=AugmentSettings)
    seed: int = 0


def power_loss(predicted, labels, p):
    """|pred - label|^p, mean over the dims after the batch's
    (optimize.py:37-47). predicted [..., B, L] against labels [B, L]."""
    per_example = torch.abs(predicted - labels) ** p
    return per_example.reshape(per_example.shape[:-1] + (-1,)).mean(-1)


def _per_net(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] values shaped to broadcast against a stacked [N, ...] leaf."""
    return values.reshape((-1,) + (1,) * (like.dim() - 1)).to(like.dtype)


class Sgd:
    """optax.sgd(lr, momentum=0.9): the trace t = g + 0.9 t, then -lr t.
    State: {"trace": tree}."""

    def __init__(self, learning_rate: float, momentum: float = 0.9):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params):
        return {"trace": tree_map(torch.zeros_like, params)}

    def update(self, grads, state):
        m = self.momentum
        trace = tree_map(lambda g, t: g + m * t, grads, state["trace"])
        return tree_map(lambda t: -self.learning_rate * t, trace), {"trace": trace}


class Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, eps_root 0, in optax's
    order of operations; the count (int32) is per net. State: {"count": [N],
    "mu": tree, "nu": tree}."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params):
        n = next(iter(_leaves(params))).shape[0]
        device = next(iter(_leaves(params))).device
        return {"count": torch.zeros(n, dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state["mu"])
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state["nu"])
        count = state["count"] + 1
        exponent = count.to(torch.float32)
        correction1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                                 device=count.device), exponent)
        correction2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                                 device=count.device), exponent)

        def step(m, v):
            m_hat = m / _per_net(correction1, m)
            v_hat = v / _per_net(correction2, v)
            return -self.learning_rate * (m_hat / (torch.sqrt(v_hat + self.eps_root) + self.eps))

        return tree_map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}


def make_optimizer(name: str, learning_rate: float):
    if name == SGD:
        return Sgd(learning_rate)
    if name == ADAM:
        return Adam(learning_rate)
    raise ValueError(f"unknown optimizer name: {name}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _flax_init(template: Dict, generator: torch.Generator) -> Dict:
    """One net's parameters by flax's default initializers: lecun_normal (a
    normal truncated at 2 standard deviations, variance 1 / fan_in) for
    conv and dense kernels, zero biases, batch-norm scale 1 and bias 0,
    LinearBias kernels 0."""

    def fill(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = fill(value, path + (key,))
                continue
            shape = tuple(value.shape)
            if key == "kernel" and not path[0].startswith("LinearBias_"):
                fan_in = int(np.prod(shape[:-1]))
                # flax's variance_scaling: stddev of the untruncated normal.
                std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(shape, dtype=torch.float64)
                torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
                out[key] = (t * std).to(torch.float32)
            elif key == "scale":
                out[key] = torch.ones(shape)
            else:
                out[key] = torch.zeros(shape)
        return out

    return fill(template, ())


def init_ensemble(model, example_inputs: Dict[str, np.ndarray], num_nets: int, tx,
                  seed: int = 0, device="cpu") -> EnsembleState:
    """``num_nets`` independently drawn parameter sets of ``model`` (flax's
    initializers, one ``torch.Generator`` seeded with ``seed``), stacked on
    axis 0 on ``device``; batch statistics mean 0 and variance 1."""
    frame = example_inputs.get(models_lib.FRAME_IMG)
    if frame is not None and tuple(np.shape(frame)[1:]) != tuple(model.input_shape):
        raise ValueError(f"example frame {np.shape(frame)[1:]} for a net built for "
                         f"{tuple(model.input_shape)}")
    template = convert.flax_variables(model)
    generator = torch.Generator().manual_seed(seed)
    nets = [_flax_init(template["params"], generator) for _ in range(num_nets)]
    params = tree_map(lambda *xs: torch.stack(xs).to(device), *nets)
    stats = [_stats_init(template["batch_stats"]) for _ in range(num_nets)]
    batch_stats = tree_map(lambda *xs: torch.stack(xs).to(device), *stats) if stats[0] else {}
    return EnsembleState(params, batch_stats, tx.init(params),
                         torch.ones(num_nets, dtype=torch.float32, device=device))


def _stats_init(template: Dict) -> Dict:
    return {k: _stats_init(v) if isinstance(v, dict)
            else (torch.zeros(v.shape) if k == "mean" else torch.ones(v.shape))
            for k, v in template.items()}


def per_net_forward(model, params: Dict, batch_stats: Dict, inputs: Dict[str, torch.Tensor],
                    train: bool, generator: torch.Generator = None):
    """The stacked ensemble one net after another through ``model`` (any
    net of ml/models.py), in train or eval mode; the counterpart of the JAX
    package's vmapped path. Returns (out [N, B, L] float32, new batch_stats
    stacked like the input). Tallies ``train.per_net_forwards``, one a
    net."""
    model.train(train)
    n = next(iter(_leaves(params))).shape[0]
    profiling.count("train.per_net_forwards", n)
    outs, stats = [], []
    for i in range(n):
        stats_i = tree_map(lambda t: t[i].clone(), batch_stats)
        tensors = convert.module_tensors(model, tree_map(lambda t: t[i], params), stats_i)
        outs.append(functional_call(model, tensors, (inputs,), {"generator": generator}).float())
        stats.append(stats_i)
    new_stats = tree_map(lambda *xs: torch.stack(xs), *stats) if batch_stats else {}
    return torch.stack(outs), new_stats


def _forward_for(model):
    return folded.folded_forward if folded.foldable(model) else per_net_forward


def _select_per_net(mask, new_tree, old_tree):
    """Per-net selection between updated and previous trees."""
    return tree_map(lambda new, old: torch.where(_per_net(mask, new).bool(), new, old),
                    new_tree, old_tree)


def _float_images(inputs):
    images = inputs[models_lib.FRAME_IMG]
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    return images


def make_train_step(model, tx, settings: TrainSettings):
    """The ensemble train step: step(state, inputs, labels, weights,
    use_mask, generator, draws=None, dropout_masks=None) -> (state,
    mean_loss [N], per_example [N, B]).

    inputs: dict of [B, ...] tensors on the state's device (frame images may
    be uint8: they become float /255 there); labels [B, L]; weights [N, B];
    use_mask [N] bool; generator: the device's draws for augmentation, then
    dropout. A block of a sharded ensemble gets the augmentation's
    ``draws`` and the folded path's ``dropout_masks`` made for the whole
    ensemble (``train_models``). The gradient is taken of the sum of the
    nets' losses, each net's own gradient since their parameters are
    independent."""
    forward = _forward_for(model)

    def step(state: EnsembleState, inputs, labels, weights, use_mask, generator, draws=None,
             dropout_masks=None):
        images = _float_images(inputs)
        if draws is None:
            draws = draw_augmentation(generator, images.shape[0], settings.augment,
                                      images.device)
        images, labels = augment_batch(images, labels, settings.augment, draws)
        net_inputs = dict(inputs)
        net_inputs[models_lib.FRAME_IMG] = images

        params = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
        masks = {} if dropout_masks is None else {"dropout_masks": dropout_masks}
        out, new_stats = forward(model, params, state.batch_stats, net_inputs, True, generator,
                                 **masks)
        per_example = power_loss(out, labels, settings.loss_norm_pow)  # [N, B]
        losses = torch.mean(per_example * weights, dim=1)  # [N]
        leaves = list(_leaves(params))
        grads = iter(torch.autograd.grad(losses.sum(), leaves))
        grads = tree_map(lambda _: next(grads), params)
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = tree_map(lambda p, u: (p + u * _per_net(state.lr_scale, u)).detach(),
                              state.params, updates)
        new_state = EnsembleState(
            _select_per_net(use_mask, new_params, state.params),
            _select_per_net(use_mask, new_stats, state.batch_stats),
            _select_per_net(use_mask, new_opt, state.opt_state),
            state.lr_scale,
        )
        return new_state, losses.detach(), per_example.detach()

    return step


def make_eval_step(model, settings: TrainSettings):
    """step(state, inputs, labels) -> mean loss per net [N], eval mode
    (running statistics, no dropout), the frame centre-cropped to the
    settings' target width."""
    forward = _forward_for(model)
    target_width = settings.augment.target_width

    @torch.no_grad()
    def step(state: EnsembleState, inputs, labels):
        images = _float_images(inputs)
        if target_width > 0:
            images = center_crop_width(images, target_width)
        net_inputs = dict(inputs)
        net_inputs[models_lib.FRAME_IMG] = images
        out, _ = forward(model, state.params, state.batch_stats, net_inputs, False)
        return torch.mean(power_loss(out, labels, settings.loss_norm_pow), dim=1)

    return step


def _write(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(tree))


def save_net(state: EnsembleState, net_idx: int, path: str) -> None:
    """Serialise ensemble member ``net_idx`` of the stacked state (flax
    msgpack)."""
    def member(t):
        return np.ascontiguousarray(t[net_idx].detach().cpu().numpy())
    _write(path, {"params": tree_map(member, state.params),
                  "batch_stats": tree_map(member, state.batch_stats)})


def save_module(net, path: str) -> None:
    """Serialise one ml/models.py net (flax msgpack)."""
    _write(path, convert.flax_variables(net))


def load_net(path: str) -> Dict[str, Any]:
    """One checkpoint as its flax tree of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def load_ensemble_params(paths: List[str]) -> Dict[str, Any]:
    """Per-net checkpoint files stacked into ensemble trees (leading axis:
    the net), as the JAX package's load_ensemble_params."""
    loaded = [load_net(p) for p in paths]
    return {"params": _stack([t["params"] for t in loaded]),
            "batch_stats": _stack([t["batch_stats"] for t in loaded])}


@dataclass
class TrainLogEvent:
    """Per-epoch scalars, streamed to ``log_path`` as JSON lines with the JAX
    package's keys (the reference's tensorboard train/val curves plus its
    console line's fields)."""

    epoch: int
    train_loss: float
    val_loss: float
    epoch_duration_sec: float
    examples_per_sec: float
    train_loss_per_net: Optional[List[float]] = None
    val_loss_per_net: Optional[List[float]] = None
    improvement_marker: str = ""
    # Per-net LR multipliers after this epoch's plateau update.
    lr_scale_per_net: Optional[List[float]] = None


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms within, the caller's choice after."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@_deterministic_cudnn()
def train_models(
    model,
    state: EnsembleState,
    tx,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    input_names: List[str],
    label_name: str,
    weighters: List,
    settings: TrainSettings,
    out_dir: str,
    print_log: bool = True,
    log_path: Optional[str] = None,
    net_out_specs: Optional[List[tuple]] = None,
    devices: Optional[Sequence] = None,
) -> List[TrainLogEvent]:
    """The training loop of TrainModels (optimize.py:77-212) on the state's
    device.

    ``net_out_specs``: optional per-net (directory, local_index) checkpoint
    routing, for the grouped hyperparameter search, where one
    super-ensemble trains several grid folds and each fold's nets land in
    that fold's directory under fold-local names.

    ``devices``: with more than one, the nets are split into contiguous
    blocks, one a device (parallel/mesh.py; the JAX package shards the
    state's net axis over its mesh). Each device runs the train and eval
    steps for its nets on the same batch, copied to it; each net's
    checkpoint is written from its device. The draws stay the unsharded
    run's: the augmentation is drawn once, on the state's device, from the
    one generator and copied to every device; the folded path's dropout
    masks are drawn there for the whole ensemble and sliced by block
    (ml/folded.py), and the per-net path draws each net's masks from the
    same generator in net order (ml/models.py: ``dropout``). The host's
    bookkeeping (weights [N, B], skip mask, lr_scale, plateau counters,
    losses) is sliced by block and gathered back in net order.

    The batches reach the devices through ml/staging.py (``open_staging``:
    on CUDA devices a worker thread gathers the next batches into pinned
    buffers and copy streams send them; elsewhere the batch is gathered and
    copied when it is staged). The host draws each epoch's permutation and
    use masks in the JAX package's order, an epoch ahead, so that the next
    epoch's first batches are gathered while an epoch ends.

    Under ``utils.profiling.recording(timer)`` the loop records spans:
    ``train.epoch`` (attribute ``epoch``) around ``train.batch`` (the next
    batch's weights, its gather or the wait for it, and its copies
    queued), ``train.step`` (the step's
    dispatch) and ``train.epoch_end`` (``train.pull``, ``train.validate``,
    ``train.checkpoint``, ``train.log``), then ``train.checkpoint`` for the
    last saves; and tallies ``train.steps``, ``train.skipped_batches``,
    ``train.val_batches``, ``train.checkpoints``, and ml/staging.py's
    ``train.h2d_bytes`` (and on CUDA devices ``train.h2d_pinned_bytes`` and
    ``train.staging_waits``).
    Without a recorder nothing is recorded; what the loop computes and
    writes is the same either way."""
    num_nets = len(weighters)
    if net_out_specs is None:
        net_out_specs = [(out_dir, n) for n in range(num_nets)]
    device = state.lr_scale.device
    train_step = make_train_step(model, tx, settings)
    eval_step = make_eval_step(model, settings)
    host_rng = np.random.default_rng(settings.seed)
    generator = torch.Generator(device=device).manual_seed(settings.seed + 1)

    # The net blocks: (lo, hi, device, state), one a device that holds nets.
    if devices is not None and len(devices) > 1:
        mesh = make_mesh(("ensemble",), None, devices)
        blocks = [(lo, hi, dev, part) for (lo, hi), dev, part in zip(
            block_bounds(num_nets, mesh.size), mesh.devices,
            shard_leading_axis(state, mesh, "ensemble")) if hi > lo]
    else:
        blocks = [(0, num_nets, device, state)]
    sharded = len(blocks) > 1
    folded_dropout = sharded and folded.foldable(model)

    num_train = train_data[label_name].shape[0]
    num_val = val_data[label_name].shape[0]

    log: List[TrainLogEvent] = []
    min_val_losses = np.full((num_nets,), np.inf)
    min_val_loss = np.inf
    # Seeded from the incoming state, so per-fold ratios installed by the
    # caller compose with the plateau halving.
    lr_scale = state.lr_scale.detach().cpu().numpy().astype(np.float32).copy()
    plateau_counters = np.zeros((num_nets,), np.int64)
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    log_file = open(log_path, "a") if log_path else None

    def stage_batch(staging, idx, use_mask):
        """Batch k + 1 staged before step k is dispatched (ml/staging.py):
        its rows, its weights and its use mask on the devices."""
        with profiling.stage("train.batch"):
            weights = np.stack([w.get_weights(idx) for w in weighters]).astype(np.float32)
            return staging.send(weights, use_mask)

    def run_train_step(staged):
        """Every block's step on the staged batch; returns (losses [N],
        per_example [N, B]) on the state's device."""
        staged.wait()
        draws = masks = None
        if sharded:
            size = next(iter(staged.batch.values()))[1].shape[0]
            draws = draw_augmentation(generator, size, settings.augment, device)
            if folded_dropout:
                masks = folded.ensemble_dropout_masks(model, blocks[0][3].params, num_nets,
                                                      size, generator)
        results = []
        for b, (lo, hi, dev, part) in enumerate(blocks):
            inputs, labels = staged.batch[dev]
            part, losses, per_example = train_step(
                part, inputs, labels, staged.weights[b], staged.masks[b], generator,
                draws=None if draws is None else type(draws)(
                    *(None if t is None else t.to(dev) for t in draws)),
                dropout_masks=None if masks is None else folded.block_dropout_masks(
                    masks, num_nets, lo, hi, dev))
            blocks[b] = (lo, hi, dev, part)
            results.append((losses, per_example))
        if not sharded:
            return results[0]
        return gather_leading_axis(results, device)

    def draw_epoch(staging):
        """The host's draws for an epoch, in the JAX package's order (its
        permutation, then each batch's use mask): the batch count and the
        (indices, use mask) of each batch to stage, planned with the
        staging."""
        order = list(data_lib.batches(num_train, settings.batch_size, host_rng))
        use_masks = [host_rng.uniform(size=num_nets) < settings.batch_use_prob for _ in order]
        kept = [(idx, use_mask) for idx, use_mask in zip(order, use_masks)
                if staging.stages_skipped or use_mask.any()]
        staging.plan(train_data, [idx for idx, _ in kept])
        return len(order), kept

    val_order = list(data_lib.batches(num_val, settings.batch_size, None))
    with staging_lib.open_staging(input_names, label_name,
                                  [(lo, hi, dev) for lo, hi, dev, _ in blocks],
                                  settings.batch_size) as staging:
        upcoming = draw_epoch(staging) if settings.epochs > 0 else None
        for epoch in range(settings.epochs):
            with profiling.stage("train.epoch", epoch=epoch):
                epoch_start = time.time()
                running = np.zeros((num_nets,))
                seen = np.zeros((num_nets,), np.int64)
                # Per-step results stay on the device during the epoch; the pulls
                # and the weighters' registration come at its end, in step order
                # (a weighter's weights change only at step()).
                pending: List[tuple] = []
                # This epoch's validation, then the next epoch's batches, are
                # planned behind this epoch's (so staged while it ends).
                num_batches, train_batches = upcoming
                if len(train_batches) < num_batches:
                    profiling.count("train.skipped_batches", num_batches - len(train_batches))
                staging.plan(val_data, val_order)
                if epoch + 1 < settings.epochs:
                    upcoming = draw_epoch(staging)
                staged = stage_batch(staging, *train_batches[0]) if train_batches else None
                for k, (idx, use_mask) in enumerate(train_batches):
                    current = staged
                    if k + 1 < len(train_batches):
                        staged = stage_batch(staging, *train_batches[k + 1])
                    if not use_mask.any():
                        profiling.count("train.skipped_batches")
                        continue
                    with profiling.stage("train.step"):
                        losses, per_example = run_train_step(current)
                    profiling.count("train.steps")
                    pending.append((idx, use_mask, losses, per_example))
                with profiling.stage("train.epoch_end"):
                    with profiling.stage("train.pull"):
                        for idx, use_mask, losses, per_example in pending:
                            losses_np = losses.cpu().numpy()
                            per_example_np = per_example.cpu().numpy()
                            for n, w in enumerate(weighters):
                                if use_mask[n]:
                                    w.register_losses(idx, per_example_np[n])
                                    running[n] += losses_np[n] * len(idx)
                                    seen[n] += len(idx)
                        epoch_duration = time.time() - epoch_start
                        examples_per_sec = float(seen.sum()) / max(epoch_duration, 1e-9)
                        avg_loss = float(running.sum() / max(seen.sum(), 1))

                        for w in weighters:
                            w.step()

                    with profiling.stage("train.validate"):
                        val_losses = []
                        for _ in val_order:
                            staged = staging.send()
                            staged.wait()
                            val_losses.append(torch.cat([
                                eval_step(part, *staged.batch[dev]).to(device)
                                for _, _, dev, part in blocks]))
                            profiling.count("train.val_batches")
                        # One pull, summed on the host in batch order.
                        val_total = np.zeros((num_nets,))
                        if val_losses:
                            for losses_np, idx in zip(torch.stack(val_losses).cpu().numpy(),
                                                      val_order):
                                val_total += losses_np * len(idx)
                        val_avg = val_total / max(num_val, 1)
                        val_avg_all = float(val_avg.mean())

                    marker = ""
                    if val_avg_all < min_val_loss:
                        marker = " ***"
                        min_val_loss = val_avg_all
                    elif val_avg_all * 0.9 < min_val_loss:
                        marker = " *"

                    with profiling.stage("train.checkpoint"):
                        for n in range(num_nets):
                            if val_avg[n] < min_val_losses[n]:
                                min_val_losses[n] = val_avg[n]
                                plateau_counters[n] = 0
                                spec_dir, spec_idx = net_out_specs[n]
                                _save_from_block(blocks, n, data_lib.model_file_name(
                                    spec_dir, spec_idx, data_lib.BEST))
                                profiling.count("train.checkpoints")
                            elif settings.plateau_patience_epochs > 0:
                                plateau_counters[n] += 1
                                if plateau_counters[n] > settings.plateau_patience_epochs:
                                    lr_scale[n] *= 0.5
                                    plateau_counters[n] = 0
                    blocks = [(lo, hi, dev, part._replace(
                        lr_scale=torch.as_tensor(lr_scale[lo:hi], device=dev)))
                        for lo, hi, dev, part in blocks]

                    with profiling.stage("train.log"):
                        event = TrainLogEvent(
                            epoch, avg_loss, val_avg_all, epoch_duration, examples_per_sec,
                            train_loss_per_net=list(np.round(running / np.maximum(seen, 1), 8)),
                            val_loss_per_net=list(np.round(val_avg, 8)),
                            improvement_marker=marker.strip(),
                            lr_scale_per_net=[float(s) for s in lr_scale],
                        )
                        log.append(event)
                        if print_log:
                            print(
                                f"Epoch {epoch};  loss {avg_loss:g};  val loss: {val_avg_all:g};  "
                                f"{epoch_duration:0.2f} sec/epoch; "
                                f"{examples_per_sec:0.2f} examples/sec{marker}"
                            )
                        if log_file:
                            log_file.write(json.dumps(event.__dict__) + "\n")
                            log_file.flush()

        with profiling.stage("train.checkpoint"):
            for n in range(num_nets):
                spec_dir, spec_idx = net_out_specs[n]
                _save_from_block(blocks, n, data_lib.model_file_name(spec_dir, spec_idx,
                                                                     data_lib.LAST))
                profiling.count("train.checkpoints")
    if log_file:
        log_file.close()
    return log


def _save_from_block(blocks, net_idx: int, path: str) -> None:
    """``save_net`` of ensemble member ``net_idx`` from the block (lo, hi,
    device, state) that holds it, on its device."""
    for lo, hi, _, part in blocks:
        if lo <= net_idx < hi:
            save_net(part, net_idx - lo, path)
            return
    raise IndexError(f"net {net_idx} is in no block")
