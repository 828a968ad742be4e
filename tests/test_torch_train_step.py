"""The port's ensemble train and eval steps (pilotguru_tpu_torch.ml.training)
against the JAX package's on the same parameters and batch, at dropout 0.

- The folded PilotNet at its published width (66x200x3, batch 4, N = 2),
  Adam, non-uniform weights, net 1 masked off: losses, per-example losses,
  parameters, batch statistics and Adam's moments and counts after the
  step, and the masked net unchanged to the bit. The JAX step is compiled
  once for the module.
- ToyConvNet, narrow, on the per-net path against the JAX package's vmapped
  path: SGD, lr_scale 1 and 0.5, p = 1 loss.
- The eval steps on the JAX package's state after its steps.
Tolerances are float32's: the two packages sum the convolutions, products
and batch statistics in other orders. Train-mode batch norm over 4 examples
amplifies that rounding: against a float64 run of the same step, the JAX
package's float32 PilotNet outputs read 8.4e-5 off and the port's 3.3e-5,
of outputs up to 0.7, so the losses are held to 5e-4; against float64
gradients, the JAX package's float32 ones read up to 1.9e-2 of their
layer's largest (ConvBlock_2's batch-norm bias), the port's 7.8e-4
(FcBlock_0's kernel); against the JAX package's, 14 of ConvBlock_2's
43,200 kernel gradients read 2.5 to 4.9% of the layer's largest apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.ml import augmentation as jax_aug
from pilotguru_tpu.ml import models as jax_models
from pilotguru_tpu.ml import training as jax_training
from pilotguru_tpu_torch.ml import augmentation, convert, models, training

torch.set_num_threads(2)

BIAS = [{"input_name": "forward_axis", "input_dims": 3}]


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _np_tree(tree):
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _batch(rng, b, h, w):
    return ({"frame_img": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
             "forward_axis": rng.normal(0, 1, (b, 3)).astype(np.float32)},
            rng.normal(0, 0.5, (b, 1)).astype(np.float32))


def _port_state(jax_state, optimizer):
    params, stats = convert.ensemble_from_flax(_np_tree(jax_state.params),
                                               _np_tree(jax_state.batch_stats))
    opt = jax_state.opt_state[0]
    if optimizer == "adam":
        mu, _ = convert.ensemble_from_flax(_np_tree(opt.mu), {})
        nu, _ = convert.ensemble_from_flax(_np_tree(opt.nu), {})
        opt_state = {"count": torch.as_tensor(np.asarray(opt.count)), "mu": mu, "nu": nu}
    else:
        trace, _ = convert.ensemble_from_flax(_np_tree(opt.trace), {})
        opt_state = {"trace": trace}
    return training.EnsembleState(params, stats, opt_state,
                                  torch.as_tensor(np.asarray(jax_state.lr_scale)))


def _torch_inputs(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


@pytest.fixture(scope="module")
def pilotnet_step():
    """One Adam step of the folded PilotNet x2 in both packages, from the
    same state and batch; net 1 masked off."""
    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    settings_kw = dict(epochs=1, batch_size=4, learning_rate=1e-3, optimizer="adam")
    jax_model = jax_models.make_network(options, BIAS)
    tx = jax_training.make_optimizer("adam", 1e-3)
    rng = np.random.default_rng(11)
    inputs, labels = _batch(rng, 4, 66, 200)
    example = {"frame_img": np.zeros((1, 66, 200, 3), np.float32),
               "forward_axis": np.zeros((1, 3), np.float32)}
    state = jax_training.init_ensemble(jax_model, example, 2, tx, seed=3)
    # Non-zero LinearBias weights and running statistics, so that every
    # term of the forward is exercised.
    params = _np_tree(state.params)
    params["LinearBias_0"]["Dense_0"]["kernel"] = rng.normal(0, 0.1, (2, 3, 1)).astype(np.float32)
    stats = _np_tree(state.batch_stats)
    for block in stats.values():
        block["BatchNorm_0"]["mean"] = rng.normal(0, 0.1, block["BatchNorm_0"]["mean"].shape
                                                  ).astype(np.float32)
        block["BatchNorm_0"]["var"] = rng.uniform(0.5, 1.5, block["BatchNorm_0"]["var"].shape
                                                  ).astype(np.float32)
    state = state._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    port_state = _port_state(state, "adam")
    before = _flat(_np_tree(state.params))
    weights = rng.uniform(0.2, 2.0, (2, 4)).astype(np.float32)
    mask = np.array([True, False])
    jax_settings = jax_training.TrainSettings(
        **settings_kw, augment=jax_aug.AugmentSettings(target_width=200))
    step = jax_training.make_train_step(jax_model, tx, jax_settings)
    jax_state, jax_losses, jax_per = step(state, inputs, labels, weights, jnp.asarray(mask),
                                          jax.random.PRNGKey(0))
    jax_eval = jax_training.make_eval_step(jax_model, jax_settings)(jax_state, inputs, labels)

    model = models.make_network(options, BIAS, (66, 200, 3))
    settings = training.TrainSettings(
        **settings_kw, augment=augmentation.AugmentSettings(target_width=200))
    port_step = training.make_train_step(model, training.make_optimizer("adam", 1e-3), settings)
    new_state, losses, per = port_step(
        port_state, _torch_inputs(inputs), torch.as_tensor(labels), torch.as_tensor(weights),
        torch.as_tensor(mask), torch.Generator().manual_seed(0))
    return dict(before=before, stats_before=_flat(stats), jax_state=jax_state,
                jax_losses=np.asarray(jax_losses), jax_per=np.asarray(jax_per),
                jax_eval=np.asarray(jax_eval), state=new_state, losses=losses.numpy(),
                per=per.numpy(), model=model, settings=settings, inputs=inputs, labels=labels)


def test_pilotnet_folded_adam_step_losses(pilotnet_step):
    r = pilotnet_step
    np.testing.assert_allclose(r["per"], r["jax_per"], rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(r["losses"], r["jax_losses"], rtol=1e-3, atol=5e-4)


def _pre_norm_bias(name):
    return name.endswith("/Conv_0/bias") or (name.startswith("FcBlock_")
                                             and name.endswith("Dense_0/bias"))


def test_pilotnet_folded_adam_step_parameters_and_state(pilotnet_step):
    r = pilotnet_step
    opt = r["jax_state"].opt_state[0]
    jax_mu = _flat(_np_tree(opt.mu))
    jax_params = _flat(_np_tree(r["jax_state"].params))
    params, stats = convert.ensemble_to_flax(r["state"].params, r["state"].batch_stats)
    params, stats = _flat(params), _flat(stats)
    assert params.keys() == jax_params.keys()
    for name, want in jax_params.items():
        got = params[name]
        # The masked-off net: unchanged to the bit.
        np.testing.assert_array_equal(got[1], r["before"][name][1])
        np.testing.assert_array_equal(want[1], r["before"][name][1])
        # Adam steps each parameter by about lr times the sign of its
        # gradient. Where the gradient is within float32's error of 0 (a
        # bias just before batch norm, which removes the batch mean; an
        # element under 10% of its layer's largest gradient) either package
        # may take either sign: those are held to the step's bound, lr.
        step = np.abs(got[0] - r["before"][name][0])
        assert step.max() <= 1e-3 * 1.001, name  # lr, and the sum's rounding
        if _pre_norm_bias(name):
            continue
        sure = np.abs(jax_mu[name][0]) >= 0.1 * np.abs(jax_mu[name][0]).max()
        assert sure.sum() >= min(10, sure.size // 4), name
        np.testing.assert_allclose(got[0][sure], want[0][sure], rtol=0, atol=2e-6, err_msg=name)
    jax_stats = _flat(_np_tree(r["jax_state"].batch_stats))
    for name, want in jax_stats.items():
        np.testing.assert_array_equal(stats[name][1], r["stats_before"][name][1])
        np.testing.assert_allclose(stats[name][0], want[0], rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(r["state"].opt_state["count"].numpy(), np.asarray(opt.count))
    np.testing.assert_array_equal(np.asarray(opt.count), [1, 0])
    for key in ("mu", "nu"):
        got_tree = _flat(convert.ensemble_to_flax(r["state"].opt_state[key], {})[0])
        for name, want in _flat(_np_tree(getattr(opt, key))).items():
            np.testing.assert_array_equal(got_tree[name][1], 0.0)
            if _pre_norm_bias(name):
                continue
            # The gradients' float32 errors (above): 99.9% of each layer's
            # within 2.5e-2 of its largest, all within 0.1; twice that for
            # the squares.
            scale = np.abs(want[0]).max() * (1.0 if key == "mu" else 2.0)
            gap = np.abs(got_tree[name][0] - want[0]) / scale
            assert np.mean(gap <= 2.5e-2) >= 0.999 and gap.max() <= 0.1, (key, name, gap.max())


def test_pilotnet_eval_step(pilotnet_step):
    """The port's eval step on the JAX package's state after its step."""
    r = pilotnet_step
    params, stats = convert.ensemble_from_flax(_np_tree(r["jax_state"].params),
                                               _np_tree(r["jax_state"].batch_stats))
    state = r["state"]._replace(params=params, batch_stats=stats)
    got = training.make_eval_step(r["model"], r["settings"])(
        state, _torch_inputs(r["inputs"]), torch.as_tensor(r["labels"]))
    np.testing.assert_allclose(got.numpy(), r["jax_eval"], rtol=2e-5, atol=1e-6)


def test_toy_net_per_net_sgd_step_against_the_vmapped_path():
    options = {"net_name": "toy", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    rng = np.random.default_rng(5)
    inputs, labels = _batch(rng, 6, 40, 44)
    del inputs["forward_axis"]
    jax_model = jax_models.make_network(options, [])
    tx = jax_training.make_optimizer("sgd", 0.05)
    state = jax_training.init_ensemble(
        jax_model, {"frame_img": np.zeros((1, 40, 40, 3), np.float32)}, 2, tx, seed=1)
    state = state._replace(lr_scale=jnp.asarray([1.0, 0.5], jnp.float32))
    port_state = _port_state(state, "sgd")
    before = _flat(_np_tree(state.params))
    weights = rng.uniform(0.2, 2.0, (2, 6)).astype(np.float32)
    mask = np.array([True, True])
    kw = dict(epochs=1, batch_size=6, learning_rate=0.05, optimizer="sgd", loss_norm_pow=1.0)
    jax_settings = jax_training.TrainSettings(**kw, augment=jax_aug.AugmentSettings(target_width=40))
    jax_state, jax_losses, jax_per = jax_training.make_train_step(jax_model, tx, jax_settings)(
        state, inputs, labels, weights, jnp.asarray(mask), jax.random.PRNGKey(0))
    jax_eval = jax_training.make_eval_step(jax_model, jax_settings)(jax_state, inputs, labels)

    model = models.make_network(options, [], (40, 40, 3))
    settings = training.TrainSettings(**kw, augment=augmentation.AugmentSettings(target_width=40))
    new_state, losses, per = training.make_train_step(
        model, training.make_optimizer("sgd", 0.05), settings)(
        port_state, _torch_inputs(inputs), torch.as_tensor(labels), torch.as_tensor(weights),
        torch.as_tensor(mask), torch.Generator().manual_seed(0))
    # Train-mode batch norm over 6 examples: read 6.9e-5 apart at most.
    np.testing.assert_allclose(per.numpy(), np.asarray(jax_per), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jax_losses), rtol=2e-4, atol=1e-5)
    params, stats = convert.ensemble_to_flax(new_state.params, new_state.batch_stats)
    for name, want in _flat(_np_tree(jax_state.params)).items():
        step_size = np.abs(want - before[name]).max()
        assert step_size > 0, name
        np.testing.assert_allclose(_flat(params)[name], want, rtol=0,
                                   atol=1e-6 + 1e-4 * step_size, err_msg=name)
    for name, want in _flat(_np_tree(jax_state.batch_stats)).items():
        np.testing.assert_allclose(_flat(stats)[name], want, rtol=1e-5, atol=1e-6)
    trace = _flat(convert.ensemble_to_flax(new_state.opt_state["trace"], {})[0])
    for name, want in _flat(_np_tree(jax_state.opt_state[0].trace)).items():
        if _pre_norm_bias(name):
            # The gradient of a bias just before batch norm is 0 up to
            # rounding, in both packages.
            assert np.abs(trace[name]).max() < 1e-5 and np.abs(want).max() < 1e-5, name
            continue
        np.testing.assert_allclose(trace[name], want, rtol=0,
                                   atol=1e-6 + 1e-4 * np.abs(want).max(), err_msg=name)
    params, stats = convert.ensemble_from_flax(_np_tree(jax_state.params),
                                               _np_tree(jax_state.batch_stats))
    port_eval = training.make_eval_step(model, settings)(
        new_state._replace(params=params, batch_stats=stats), _torch_inputs(inputs),
        torch.as_tensor(labels))
    np.testing.assert_allclose(port_eval.numpy(), np.asarray(jax_eval), rtol=2e-5, atol=1e-6)


class _StepBuilt(Exception):
    pass


def test_train_models_runs_with_deterministic_cudnn(monkeypatch):
    """The training loop asks cuDNN for its deterministic algorithms (a run
    on the card repeats) and gives the caller's choice back after, on an
    exception too."""
    seen = []

    def record(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        raise _StepBuilt

    monkeypatch.setattr(training, "make_train_step", record)
    before = torch.backends.cudnn.deterministic
    state = training.EnsembleState({}, {}, {}, torch.ones(1))
    with pytest.raises(_StepBuilt):
        training.train_models(None, state, None, {}, {}, [], "steering", [None],
                              training.TrainSettings(epochs=1, batch_size=1), "")
    assert seen == [True]
    assert torch.backends.cudnn.deterministic == before
