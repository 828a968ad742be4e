"""The folded Udacity Rambo ensemble (pilotguru_tpu_torch/ml/folded.py) at
its published widths and the 100x300 crop, batch 4, N = 2, on the CPU:

- the folded train forward, loss, the gradient of every leaf and the new
  batch statistics, and the eval forward, against the per-net path
  (``training.per_net_forward``) and against the benchmark's plain
  reference (gpubench/reference/rambo.py), on seeded random weights;
- one SGD train step of the port against the JAX package's vmapped Rambo
  step on the same state and batch;
- with dropout, the folded path given explicit masks against the
  reference given each net's slices of them, and a 2-block split of the
  masks (the sharded train step's) against the unsharded forward;
- ``foldable``: Rambo and PilotNet, no other net.

The port's paths compute in float32 (the compute dtype takes float32 or
bfloat16); the reference runs in float32 and in float64 from the same
float32 values. Measured: the folded outputs read 4.0e-6 of the largest
from the per-net path and from the float32 reference, 4.9e-6 from float64
(held to 1e-4); each leaf's gradient 1.9e-5 of its largest element from
both float32 paths (held to 2e-4), and 2.8e-3 from float64
(ConvBlock_8's batch-norm shift, held to 5e-3), where the float32
reference itself reads the same 2.8e-3: train-mode batch norm over 4
examples amplifies float32's rounding. The conv and dense biases just
before batch norm have a gradient of 0 up to rounding (3e-6; held to 1e-5
absolute, of gradients up to 1.2).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gpubench.reference import rambo as reference  # noqa: E402
from pilotguru_tpu.ml import augmentation as jax_aug  # noqa: E402
from pilotguru_tpu.ml import models as jax_models  # noqa: E402
from pilotguru_tpu.ml import training as jax_training  # noqa: E402
from pilotguru_tpu_torch.ml import augmentation, convert, folded, models, training  # noqa: E402

torch.set_num_threads(2)

SHAPE = (100, 300, 3)
NETS, BATCH = 2, 4
BIAS = [{"input_name": "forward_axis", "input_dims": 3}]
CONFIG = json.loads((ROOT / "gpubench" / "configs" / "rambo-f32.json").read_text())
# Of each output's or leaf's largest magnitude (module docstring).
OUT_TOL = 1e-4
GRAD_TOL = {"per_net": 2e-4, "reference_float32": 2e-4, "reference_float64": 5e-3}
PRE_NORM_BIAS_ATOL = 1e-5


def _options(dropout=0.0):
    return {"net_name": "rambo", "net_head_dims": 10, "label_dimensions": 1,
            "dropout_prob": dropout, "compute_dtype": "float32"}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _nested(flat):
    out = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def _pre_norm_bias(name):
    return name.endswith("Conv_0/bias") or (name.startswith("FcBlock_")
                                            and name.endswith("Dense_0/bias"))


@pytest.fixture(scope="module")
def case():
    """The model, a state with every batch-norm statistic, scale and shift
    and the LinearBias kernel drawn at random, a batch and labels."""
    model = models.make_network(_options(), BIAS, SHAPE)
    state = training.init_ensemble(model, {}, NETS, training.make_optimizer("sgd", 1e-3),
                                   seed=5)
    rng = np.random.default_rng(7)

    def draw(name, value):
        if name.endswith("scale") or name.endswith("var"):
            return torch.as_tensor(rng.uniform(0.5, 1.5, value.shape), dtype=torch.float32)
        if "BatchNorm_0" in name or name.startswith("LinearBias_"):
            return torch.as_tensor(rng.normal(0, 0.1, value.shape), dtype=torch.float32)
        return value

    params = _nested({k: draw(k, v) for k, v in _flat(state.params).items()})
    stats = _nested({k: draw(k, v) for k, v in _flat(state.batch_stats).items()})
    inputs = {"frame_img": torch.as_tensor(rng.uniform(0, 1, (BATCH,) + SHAPE),
                                           dtype=torch.float32),
              "forward_axis": torch.as_tensor(rng.normal(size=(BATCH, 3)), dtype=torch.float32)}
    labels = torch.as_tensor(rng.normal(0, 0.5, (BATCH, 2)), dtype=torch.float32)
    return model, params, stats, inputs, labels


def _loss(out, labels):
    return training.power_loss(out, labels, 2.0).mean(1).sum()


def _port(forward, model, params, stats, inputs, labels, **kw):
    """out [N, B, 1], new stats and the gradient of the nets' summed loss
    by leaf."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in _flat(params).items()}
    out, new_stats = forward(model, _nested(leaves), stats, inputs, True, **kw)
    grads = torch.autograd.grad(_loss(out, labels), list(leaves.values()))
    return out.detach(), _flat(new_stats), dict(zip(leaves, grads))


def _reference(params, stats, inputs, labels, masks=None, train=True, dtype=torch.float64):
    """Per net through the plain reference: outputs, new running
    statistics (train) and gradients, in ``dtype``."""
    flat_stats = _flat(stats)
    outs, new_stats, grads = [], {}, {}
    for n in range(NETS):
        p = {k: v[n].to(dtype).requires_grad_(True) for k, v in _flat(params).items()}
        moments = {}
        running = None if train else {
            k.split("/")[0]: (flat_stats[k][n].to(dtype),
                              flat_stats[k.replace("mean", "var")][n].to(dtype))
            for k in flat_stats if k.endswith("mean")}
        out = reference.net_forward(CONFIG, p, inputs["frame_img"].to(dtype),
                                    inputs["forward_axis"].to(dtype),
                                    masks=None if masks is None else masks[n], moments=moments,
                                    running=running)
        outs.append(out.detach())
        if not train:
            continue
        loss = ((out - labels.to(dtype)) ** 2).mean(-1).mean()
        for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
            grads.setdefault(k, []).append(g)
        for block, (mean, var) in moments.items():
            for key, value in (("mean", mean), ("var", var)):
                name = f"{block}/BatchNorm_0/{key}"
                new_stats.setdefault(name, []).append(
                    0.9 * flat_stats[name][n].to(dtype) + 0.1 * value.detach())
    return (torch.stack(outs), {k: torch.stack(v) for k, v in new_stats.items()},
            {k: torch.stack(v) for k, v in grads.items()})


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name].to(g.dtype)
        if _pre_norm_bias(name):
            assert float((g - w).abs().max()) <= PRE_NORM_BIAS_ATOL, name
            continue
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= tol * scale, (name, float((g - w).abs().max()) / scale)


def _assert_out_close(got, want):
    want = want.to(got.dtype)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= OUT_TOL * float(want.abs().max())


@pytest.fixture(scope="module")
def train_runs(case):
    model, params, stats, inputs, labels = case
    return {"folded": _port(folded.folded_forward, model, params, stats, inputs, labels),
            "per_net": _port(training.per_net_forward, model, params, stats, inputs, labels),
            "reference_float32": _reference(params, stats, inputs, labels, dtype=torch.float32),
            "reference_float64": _reference(params, stats, inputs, labels)}


@pytest.mark.parametrize("other", sorted(GRAD_TOL))
def test_folded_train_forward_and_batch_statistics(train_runs, other):
    out, stats, _ = train_runs["folded"]
    want_out, want_stats, _ = train_runs[other]
    _assert_out_close(out, want_out)
    assert stats.keys() == want_stats.keys() and len(stats) == 2 * 17
    for name, value in stats.items():
        torch.testing.assert_close(value, want_stats[name].to(value.dtype), rtol=1e-5,
                                   atol=1e-6, msg=name)


@pytest.mark.parametrize("other", sorted(GRAD_TOL))
def test_folded_gradients_of_every_leaf(train_runs, other):
    _, _, grads = train_runs["folded"]
    assert len(grads) == 77  # 12 conv and 5 dense blocks, 4 dense layers, LinearBias
    _assert_grads_close(grads, train_runs[other][2], GRAD_TOL[other])


def test_folded_loss(train_runs, case):
    labels = case[4]
    got = _loss(train_runs["folded"][0], labels)
    for other in GRAD_TOL:
        want = _loss(train_runs[other][0].to(torch.float32), labels)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_folded_eval_forward(case):
    model, params, stats, inputs, _ = case
    with torch.no_grad():
        out, new_stats = folded.folded_forward(model, params, stats, inputs, False)
        per_net, _ = training.per_net_forward(model, params, stats, inputs, False)
    ref, _, _ = _reference(params, stats, inputs, None, train=False)
    assert new_stats == stats
    torch.testing.assert_close(out, per_net, rtol=0, atol=2e-6 * float(per_net.abs().max()))
    _assert_out_close(out, ref)


def test_folded_dropout_with_explicit_masks_against_the_reference(case):
    """Dropout 0.3: 12 conv masks of whole channels, then FcBlock_0, 1 and 3
    (the first dense block of each trunk); each net's slices of the folded
    masks given to the reference."""
    _, params, stats, inputs, labels = case
    model = models.make_network(_options(0.3), BIAS, SHAPE)
    generator = torch.Generator().manual_seed(3)
    masks = folded.ensemble_dropout_masks(model, params, NETS, BATCH, generator)
    names = [name for name, _ in folded._dropout_blocks(model)]
    assert names == [f"ConvBlock_{i}" for i in range(12)] + ["FcBlock_0", "FcBlock_1",
                                                            "FcBlock_3"]
    per_net = []
    for n in range(NETS):
        net = {}
        for name, mask in zip(names, masks):
            if mask.dim() == 4:
                width = mask.shape[1] // NETS
                net[name] = mask[:, n * width:(n + 1) * width].double()
            else:
                net[name] = mask[:, n].double()
        per_net.append(net)
    got = _port(folded.folded_forward, model, params, stats, inputs, labels,
                dropout_masks=masks)
    want = _reference(params, stats, inputs, labels, masks=per_net)
    _assert_out_close(got[0], want[0])
    for name, value in got[1].items():
        torch.testing.assert_close(value, want[1][name].float(), rtol=1e-5, atol=1e-6)
    _assert_grads_close(got[2], want[2], GRAD_TOL["reference_float64"])
    # Drawn from the generator, the same masks come out.
    again = _port(folded.folded_forward, model, params, stats, inputs, labels,
                  generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again[0], got[0], rtol=0, atol=0)


def test_block_dropout_masks_of_a_two_block_split(case):
    """The sharded step's 2-block split: each block's masks are the
    unsharded masks' slices, and each block's folded forward on them
    gives its nets' unsharded outputs, within the rounding of convolutions
    and batch statistics summed over other channel counts (measured: up to
    1.3e-6 of the largest output over 1 to 6 threads; held to 1e-5)."""
    _, params, stats, inputs, _ = case
    model = models.make_network(_options(0.3), BIAS, SHAPE)
    masks = folded.ensemble_dropout_masks(model, params, NETS, BATCH,
                                          torch.Generator().manual_seed(9))
    with torch.no_grad():
        whole, _ = folded.folded_forward(model, params, stats, inputs, True, dropout_masks=masks)
        for lo, hi in ((0, 1), (1, 2)):
            part = folded.block_dropout_masks(masks, NETS, lo, hi, "cpu")
            for mask, full in zip(part, masks):
                if full.dim() == 4:
                    width = full.shape[1] // NETS
                    assert torch.equal(mask, full[:, lo * width:hi * width])
                else:
                    assert torch.equal(mask, full[:, lo:hi])
            block = convert.tree_map(lambda t: t[lo:hi], params)
            block_stats = convert.tree_map(lambda t: t[lo:hi], stats)
            out, _ = folded.folded_forward(model, block, block_stats, inputs, True,
                                           dropout_masks=part)
            torch.testing.assert_close(out, whole[lo:hi], rtol=0,
                                       atol=1e-5 * float(whole.abs().max()))


def _blocks(conv_activation="relu", conv_dropout="2d"):
    """Layer block options: the defaults but the conv blocks' activation and
    dropout kind."""
    return {"conv": {"batchnorm": True, "activation": conv_activation, "dropout": conv_dropout},
            "fc": {"batchnorm": True, "activation": "relu", "dropout": "vanilla"}}


def test_foldable_takes_rambo_and_pilotnet_only():
    """Rambo and PilotNet fold (PilotNet with dropout too); other nets, a
    SELU PilotNet and a PilotNet whose conv dropout is vanilla do not."""
    for name, shape in (("nvidia", (66, 200, 3)), ("rambo", SHAPE)):
        assert folded.foldable(models.make_network(dict(_options(), net_name=name), BIAS, shape))
    for name in ("toy", "nvidia-deep", "rambo-comma", "rambo-nvidia-deep",
                 "rambo-nvidia-shallow"):
        shape = (66, 200, 3) if name == "toy" else SHAPE
        assert not folded.foldable(models.make_network(dict(_options(), net_name=name), BIAS,
                                                       shape)), name
    pilotnet = dict(_options(0.5), net_name="nvidia")
    assert folded.foldable(models.make_network(pilotnet, BIAS, (66, 200, 3)))
    for blocks in (_blocks(conv_activation="selu"), _blocks(conv_dropout="vanilla")):
        assert not folded.foldable(models.make_network(
            dict(pilotnet, layer_blocks_options=blocks), BIAS, (66, 200, 3))), blocks


def test_a_selu_pilotnet_trains_per_net():
    """A SELU PilotNet, which the fold does not compute, takes the per-net
    path in a CPU train step: ``train.per_net_forwards`` tallies each net,
    and no folded tally appears."""
    from pilotguru_tpu_torch.utils import profiling

    options = dict(_options(0.5), net_name="nvidia",
                   layer_blocks_options=_blocks(conv_activation="selu"))
    model = models.make_network(options, BIAS, (66, 200, 3))
    tx = training.make_optimizer("sgd", 1e-3)
    state = training.init_ensemble(model, {}, NETS, tx, seed=1)
    settings = training.TrainSettings(epochs=1, batch_size=BATCH,
                                      augment=augmentation.AugmentSettings(target_width=200))
    rng = np.random.default_rng(6)
    inputs = {"frame_img": torch.as_tensor(rng.integers(0, 256, (BATCH, 66, 200, 3),
                                                        dtype=np.uint8)),
              "forward_axis": torch.as_tensor(rng.normal(size=(BATCH, 3)).astype(np.float32))}
    labels = torch.as_tensor(rng.normal(0, 0.3, (BATCH, 1)).astype(np.float32))
    timer = profiling.StageTimer("step")
    with profiling.recording(timer):
        new, losses, _ = training.make_train_step(model, tx, settings)(
            state, inputs, labels, torch.ones((NETS, BATCH)), torch.ones(NETS, dtype=torch.bool),
            torch.Generator().manual_seed(0))
    assert timer.tallies.get("train.per_net_forwards") == NETS
    assert not any(name.startswith("folded.") for name in timer.tallies)
    assert torch.isfinite(losses).all() and losses.shape == (NETS,)
    assert not torch.equal(new.params["ConvBlock_0"]["Conv_0"]["kernel"],
                           state.params["ConvBlock_0"]["Conv_0"]["kernel"])


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def test_sgd_step_against_the_jax_vmapped_rambo_step():
    """One SGD step (lr 0.05, lr_scale 1 and 0.5) of the port's folded
    Rambo against the JAX package's vmapped Rambo from the JAX package's
    initial state: losses, parameters, batch statistics and the SGD trace
    (the gradient itself after one step). The two packages sum
    convolutions, products and batch statistics in other orders, and
    train-mode batch norm over 4 examples amplifies that (measured: losses
    1.2e-6 apart; of the 4.8 M trace elements 99.96% within 1e-3 of their
    leaf's largest, all within 1.4e-2, at ConvBlock_10's kernel, whose
    10x35 maps leave few rows to the statistics; running statistics
    within 2.9e-6 of their leaf's largest; the biases just before batch
    norm, whose gradient is 0 up to rounding, up to 1.2e-5 in either
    package). Held to: losses 2e-5; 99.9% within 1e-3 and all within 3e-2,
    and the parameters within that of the step; statistics 2e-5; the
    biases before batch norm 1e-4."""
    options = _options()
    rng = np.random.default_rng(21)
    inputs = {"frame_img": rng.integers(0, 256, (BATCH,) + SHAPE, dtype=np.uint8),
              "forward_axis": rng.normal(0, 1, (BATCH, 3)).astype(np.float32)}
    labels = rng.normal(0, 0.5, (BATCH, 1)).astype(np.float32)
    jax_model = jax_models.make_network(options, BIAS)
    tx = jax_training.make_optimizer("sgd", 0.05)
    state = jax_training.init_ensemble(
        jax_model, {"frame_img": np.zeros((1,) + SHAPE, np.float32),
                    "forward_axis": np.zeros((1, 3), np.float32)}, NETS, tx, seed=2)
    state = state._replace(lr_scale=jnp.asarray([1.0, 0.5], jnp.float32))
    params, stats = convert.ensemble_from_flax(_np_tree(state.params),
                                               _np_tree(state.batch_stats))
    trace, _ = convert.ensemble_from_flax(_np_tree(state.opt_state[0].trace), {})
    port_state = training.EnsembleState(params, stats, {"trace": trace},
                                        torch.as_tensor(np.array(state.lr_scale)))
    before = _flat(_np_tree(state.params))
    weights = rng.uniform(0.2, 2.0, (NETS, BATCH)).astype(np.float32)
    mask = np.array([True, True])
    kw = dict(epochs=1, batch_size=BATCH, learning_rate=0.05, optimizer="sgd")
    jax_state, jax_losses, _ = jax_training.make_train_step(
        jax_model, tx, jax_training.TrainSettings(
            **kw, augment=jax_aug.AugmentSettings(target_width=SHAPE[1])))(
        state, inputs, labels, weights, jnp.asarray(mask), jax.random.PRNGKey(0))

    model = models.make_network(options, BIAS, SHAPE)
    assert folded.foldable(model)
    settings = training.TrainSettings(
        **kw, augment=augmentation.AugmentSettings(target_width=SHAPE[1]))
    new_state, losses, _ = training.make_train_step(
        model, training.make_optimizer("sgd", 0.05), settings)(
        port_state, {k: torch.as_tensor(v) for k, v in inputs.items()}, torch.as_tensor(labels),
        torch.as_tensor(weights), torch.as_tensor(mask), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jax_losses), rtol=2e-5, atol=0)
    got_params, got_stats = convert.ensemble_to_flax(new_state.params, new_state.batch_stats)
    got_params, got_stats = _flat(got_params), _flat(got_stats)
    got_trace = _flat(convert.ensemble_to_flax(new_state.opt_state["trace"], {})[0])
    want_trace = _flat(_np_tree(jax_state.opt_state[0].trace))
    want_params = _flat(_np_tree(jax_state.params))
    assert got_trace.keys() == want_trace.keys() and len(want_trace) == 77
    gaps = []
    for name, want in want_trace.items():
        if _pre_norm_bias(name):
            assert np.abs(got_trace[name]).max() < 1e-4 and np.abs(want).max() < 1e-4, name
            continue
        gap = np.abs(got_trace[name] - want) / np.abs(want).max()
        assert gap.max() <= 3e-2, (name, gap.max())
        gaps.append(gap.ravel())
        step = np.abs(want_params[name] - before[name]).max()
        np.testing.assert_allclose(got_params[name], want_params[name], rtol=0,
                                   atol=1e-7 + 3e-2 * step, err_msg=name)
    assert np.mean(np.concatenate(gaps) <= 1e-3) >= 0.999
    for name, want in _flat(_np_tree(jax_state.batch_stats)).items():
        np.testing.assert_allclose(got_stats[name], want, rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)
