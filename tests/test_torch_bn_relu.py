"""The fused batch norm + ReLU's plain version (ml/bn_relu_kernel.py), which
the CUDA kernels repeat, against autograd of the folded path's op-by-op
``bn_train_ops`` and ReLU, on the CPU; the route a folded block's batch
norm takes (``block_bn_relu``) and its tally."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pilotguru_tpu_torch.ml import bn_relu_kernel as bk
from pilotguru_tpu_torch.ml import folded

EPS, MOMENTUM = 1e-5, 0.9

# (shape, channels-last): a conv block's activation in both layouts and an
# FC block's.
CASES = {"conv": ((4, 6, 7, 9), False), "conv_channels_last": ((4, 6, 7, 9), True),
         "fc": ((16, 10), False)}


def _case(shape, channels_last, dtype=torch.float64, seed=0):
    """x with a constant channel (its variance 0, up to rounding), g, and
    the [C] parameters and running statistics."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.as_tensor(rng.normal(0.3, 1.5, shape))
    x[:, 2] = 0.7
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.as_tensor(rng.normal(size=shape))
    params = [torch.as_tensor(v) for v in (rng.normal(1.0, 0.3, c), rng.normal(0, 0.3, c),
                                            rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c))]
    return x.to(dtype), g.to(dtype), params


def _autograd(x, g, scale, bias, mean_ra, var_ra):
    """The folded path's CPU expression and its autograd gradients."""
    xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    y, new_mean, new_var = bk.bn_train_ops(xr, sr, br, mean_ra, var_ra, EPS, MOMENTUM)
    y = F.relu(y.to(x.dtype))
    y.backward(g)
    return y.detach(), new_mean, new_var, xr.grad, sr.grad, br.grad


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_autograd_in_float64(name):
    x, g, (scale, bias, mean_ra, var_ra) = _case(*CASES[name])
    y, stats = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, EPS, MOMENTUM)
    dx, grads = bk.bn_relu_backward_plain(g, x, scale, bias, stats)
    want = _autograd(x, g, scale, bias, mean_ra, var_ra)
    got = (y, stats[3], stats[4], dx, grads[0], grads[1])
    for name_, a, b in zip(("y", "mean", "var", "dx", "dscale", "dbias"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name_)
    # The constant channel normalises to its bias, through the ReLU.
    torch.testing.assert_close(y[:, 2], torch.relu(bias[2]).expand_as(y[:, 2]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_function_takes_the_plain_version_on_the_cpu(name):
    """``bn_relu_train`` on CPU tensors: the plain version's values, and
    gradients that autograd's numerical check accepts."""
    x, g, (scale, bias, mean_ra, var_ra) = _case(*CASES[name])
    xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    y, new_mean, new_var = bk.bn_relu_train(xr, sr, br, mean_ra, var_ra, EPS, MOMENTUM)
    y.backward(g)
    assert not new_mean.requires_grad and not new_var.requires_grad
    want = _autograd(x, g, scale, bias, mean_ra, var_ra)
    for a, b in zip((y, new_mean, new_var, xr.grad, sr.grad, br.grad), want):
        torch.testing.assert_close(a.detach(), b, rtol=1e-10, atol=1e-10)
    x[:, 2] += torch.linspace(0, 0.5, x[:, 2].numel()).reshape(x[:, 2].shape)  # off the clamp
    assert torch.autograd.gradcheck(
        lambda a, b, c: bk.bn_relu_train(a, b, c, mean_ra, var_ra, EPS, MOMENTUM)[0],
        tuple(t.clone().requires_grad_(True) for t in (x, scale, bias)))


def test_the_clamped_variance_passes_no_gradient():
    """Where the raw variance is below 0 (keep 0) the variance term of dx is
    0, as the clamp's gradient is; elsewhere the two agree."""
    x, g, (scale, bias, mean_ra, var_ra) = _case((8, 5), False, seed=3)
    _, stats = bk.bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, EPS, MOMENTUM)
    clamped = stats.clone()
    clamped[2, 1] = 0.0
    dx, grads = bk.bn_relu_backward_plain(g, x, scale, bias, stats)
    dx_c, grads_c = bk.bn_relu_backward_plain(g, x, scale, bias, clamped)
    assert grads_c[3, 1] == 0 and grads[3, 1] != 0
    xhat = (x - stats[0]) * stats[1]
    gp = torch.where(xhat * scale + bias <= 0, 0.0, g)
    want = stats[1, 1] * scale[1] * (gp[:, 1] - gp[:, 1].mean())
    torch.testing.assert_close(dx_c[:, 1], want, rtol=1e-12, atol=1e-12)
    keep = torch.arange(5) != 1
    torch.testing.assert_close(dx_c[:, keep], dx[:, keep], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bfloat16_input_follows_the_float32_result(name):
    """A bfloat16 x and g against the float32 result from the same values:
    the statistics and sums see the same float32 numbers, so they agree to
    rounding; y and dx, rounded to bfloat16, within one bfloat16 ulp (2^-7
    of the value, 2^-7 of the largest near 0)."""
    x, g, params = _case(*CASES[name], dtype=torch.float32)
    x16, g16 = x.bfloat16(), g.bfloat16()
    scale, bias, mean_ra, var_ra = (p.float() for p in params)
    y16, stats16 = bk.bn_relu_train_plain(x16, scale, bias, mean_ra, var_ra, EPS, MOMENTUM)
    dx16, grads16 = bk.bn_relu_backward_plain(g16, x16, scale, bias, stats16)
    y, stats = bk.bn_relu_train_plain(x16.float(), scale, bias, mean_ra, var_ra, EPS, MOMENTUM)
    dx, grads = bk.bn_relu_backward_plain(g16.float(), x16.float(), scale, bias, stats)
    assert y16.dtype == dx16.dtype == torch.bfloat16 and stats16.dtype == torch.float32
    torch.testing.assert_close(stats16, stats, rtol=0, atol=0)
    torch.testing.assert_close(grads16, grads, rtol=0, atol=0)
    for a, b in ((y16, y), (dx16, dx)):
        torch.testing.assert_close(a.float(), b, rtol=2.0**-7, atol=2.0**-7 * float(b.abs().max()))


@pytest.mark.parametrize("shape", [(1024, 72, 31, 98), (1024, 192, 1, 18), (1024, 3492),
                                   (1024, 30), (1024, 288, 31, 98), (1024, 13968),
                                   # The folded Rambo x3's 17 layers, and its
                                   # two 5x5/2 first convs' 180 channels merged.
                                   (1024, 48, 24, 74), (1024, 96, 10, 35), (1024, 192, 3, 16),
                                   (1024, 72, 48, 148), (1024, 108, 22, 72),
                                   (1024, 144, 9, 34), (1024, 192, 4, 16), (1024, 192, 1, 7),
                                   (1024, 108, 48, 148), (1024, 144, 22, 72),
                                   (1024, 192, 10, 35), (1024, 192, 4, 17), (1024, 1536),
                                   (1024, 300), (1024, 150), (1024, 180, 48, 148)])
def test_kernel_mapping_covers_each_channel_once(shape):
    """The statistics passes' mapping at the folded nets' shapes: tiles
    of at most 64 vectors covering C, at least 8 rows a thread, about a wave
    of blocks, and no more groups of partitions than the partitions fill."""
    c = shape[1]
    rows = int(np.prod(shape)) // c
    vec, tiles, parts, groups = bk.kernel_mapping(rows, c)
    vectors = c // vec
    width = -(-vectors // tiles)
    assert c % vec == 0 and vec == (4 if c % 4 == 0 else 1)
    assert width <= 64 and (tiles - 1) * width < vectors <= tiles * width
    assert 1 <= parts and tiles * parts <= 1024 + tiles
    assert parts == 1 or rows // parts >= 8 * (256 // width)
    per_group = -(-parts // groups)
    assert groups * groups >= parts and -(-parts // per_group) <= groups <= parts


def test_folded_train_forward_on_the_cpu_takes_the_plain_path():
    """The folded forward on CPU tensors runs ``bn_train_ops`` (9 batch norms
    of a PilotNet in train mode), never the kernels' wrapper, and tallies
    nothing: ``folded.bn_fused`` counts the card's calls only."""
    from pilotguru_tpu_torch.ml import models, training
    from pilotguru_tpu_torch.utils import profiling

    options = {"net_name": "nvidia", "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (66, 200, 3))
    state = training.init_ensemble(model, {}, 2, training.make_optimizer("sgd", 1e-3), seed=1)
    rng = np.random.default_rng(2)
    inputs = {"frame_img": torch.as_tensor(rng.uniform(0, 1, (3, 66, 200, 3)).astype(np.float32)),
              "forward_axis": torch.as_tensor(rng.normal(size=(3, 3)).astype(np.float32))}
    counts = (bk.COUNTER.launches, bk.BACKWARD_COUNTER.launches)
    timer = profiling.StageTimer("forward")
    with profiling.recording(timer):
        folded.folded_forward(model, state.params, state.batch_stats, inputs, True)
        folded.folded_forward(model, state.params, state.batch_stats, inputs, False)
    assert timer.tallies == {}
    assert (bk.COUNTER.launches, bk.BACKWARD_COUNTER.launches) == counts


@pytest.mark.parametrize("device,dtype,train,want", [
    ("cpu", torch.float32, True, False), ("cuda", torch.bfloat16, True, True),
    ("cuda", torch.float32, False, False), ("cuda", torch.float32, True, True)])
def test_the_route_follows_device_and_mode(device, dtype, train, want):
    """A train-mode CUDA activation, float32 or bfloat16, takes the fused
    kernels; a CPU one and eval take PyTorch's ops."""
    x = types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)
    assert bk.takes_kernels(x, train) is want


@pytest.mark.parametrize("net,norms", [("nvidia", 9), ("rambo", 17)])
def test_a_train_step_through_the_function_tallies_each_batch_norm(net, norms, monkeypatch):
    """A folded float32 train step whose batch norms take the Function (its
    plain version on the CPU), as CUDA tensors would, tallies
    ``folded.bn_fused`` once a batch norm (9 for PilotNet, 17 for Rambo);
    its losses equal the op-by-op route's within float32 rounding (the
    plain version sums the statistics in float64). The default CPU route
    tallies nothing."""
    from pilotguru_tpu_torch.ml import augmentation, models, training
    from pilotguru_tpu_torch.utils import profiling

    height, width = (66, 200) if net == "nvidia" else (100, 300)
    options = {"net_name": net, "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (height, width, 3))
    tx = training.make_optimizer("sgd", 1e-3)
    state = training.init_ensemble(model, {}, 2, tx, seed=1)
    settings = training.TrainSettings(epochs=1, batch_size=4,
                                      augment=augmentation.AugmentSettings(target_width=width))
    rng = np.random.default_rng(5)
    inputs = {"frame_img": torch.as_tensor(rng.integers(0, 256, (4, height, width, 3),
                                                        dtype=np.uint8)),
              "forward_axis": torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32))}
    labels = torch.as_tensor(rng.normal(0, 0.3, (4, 1)).astype(np.float32))

    def step(fused):
        monkeypatch.setattr(bk, "takes_kernels", lambda x, train: fused and train)
        timer = profiling.StageTimer("step")
        with profiling.recording(timer):
            _, losses, _ = training.make_train_step(model, tx, settings)(
                state, inputs, labels, torch.ones((2, 4)), torch.ones(2, dtype=torch.bool),
                torch.Generator())
        return losses, dict(timer.tallies)

    losses, tallies = step(True)
    assert tallies.get("folded.bn_fused") == norms
    want, plain_tallies = step(False)
    assert "folded.bn_fused" not in plain_tallies
    torch.testing.assert_close(losses, want, rtol=1e-5, atol=0)
