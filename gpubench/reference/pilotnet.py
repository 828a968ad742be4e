"""A plain PilotNet ensemble: forward, loss, gradients and SGD, one net
after another, for the benchmark's comparison of training steps.

NVIDIA PilotNet (Bojarski et al., arXiv:1604.07316) as the repository's
``nvidia`` net states it: five VALID convolutions (24, 36, 48 channels at
5x5 stride 2, then 64 and 64 at 3x3), each followed by batch norm and ReLU;
the (h, w, c)-flattened trunk through dense 1164, 100, 50 and the head
width, each with batch norm and ReLU; a last dense layer to the label
dimensions; plus a linear term of the ``forward_axis`` input without bias.
Batch norm in training uses the batch's biased variance computed as
mean(x^2) - mean(x)^2 (flax's), epsilon 1e-5. The loss of one net is the
mean over the batch of |prediction - label|^2 averaged over the labels;
SGD with momentum 0.9 (trace = g + 0.9 trace, step -lr * trace) times each
net's learning-rate factor. Parameters follow the flax tree's names and
layouts, stacked on a leading net axis. Plain torch only: this module
imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
MOMENTUM = 0.9


def conv_specs(config: dict):
    return [tuple(spec) for spec in config["convs"]]


def dense_widths(config: dict):
    return list(config["dense"]) + [config["head_dims"]]


def layer_shapes(config: dict) -> dict:
    """{flat leaf name: one net's shape} of the parameter tree."""
    shapes = {}
    h, w, c = config["input_shape"]
    for i, (features, kernel, stride) in enumerate(conv_specs(config)):
        shapes[f"ConvBlock_{i}/Conv_0/kernel"] = (kernel, kernel, c, features)
        shapes[f"ConvBlock_{i}/Conv_0/bias"] = (features,)
        shapes[f"ConvBlock_{i}/BatchNorm_0/scale"] = (features,)
        shapes[f"ConvBlock_{i}/BatchNorm_0/bias"] = (features,)
        h, w, c = (h - kernel) // stride + 1, (w - kernel) // stride + 1, features
    n = h * w * c
    for i, features in enumerate(dense_widths(config)):
        shapes[f"FcBlock_{i}/Dense_0/kernel"] = (n, features)
        shapes[f"FcBlock_{i}/Dense_0/bias"] = (features,)
        shapes[f"FcBlock_{i}/BatchNorm_0/scale"] = (features,)
        shapes[f"FcBlock_{i}/BatchNorm_0/bias"] = (features,)
        n = features
    shapes["Dense_0/kernel"] = (n, config["label_dimensions"])
    shapes["Dense_0/bias"] = (config["label_dimensions"],)
    shapes["LinearBias_0/Dense_0/kernel"] = (config["bias_input_dims"],
                                            config["label_dimensions"])
    return shapes


def forward_flops(config: dict) -> int:
    """Multiply-adds of one net's forward pass on one example, counted twice
    (a multiply and an add), over the convolutions and the dense layers."""
    flops = 0
    h, w, c = config["input_shape"]
    for features, kernel, stride in conv_specs(config):
        h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        flops += 2 * h * w * features * kernel * kernel * c
        c = features
    n = h * w * c
    for features in dense_widths(config) + [config["label_dimensions"]]:
        flops += 2 * n * features
        n = features
    return flops + 2 * config["bias_input_dims"] * config["label_dimensions"]


def initial_params(config: dict, nets: int, seed: int, device) -> dict:
    """Flax's initial values drawn from ``seed`` on ``device`` in one call:
    conv and dense kernels lecun-normal (a normal truncated at two standard
    deviations, variance 1 / fan_in), the forward-axis kernel, every bias
    and batch-norm shift zero, batch-norm scales one."""
    shapes = layer_shapes(config)
    kernels = [name for name in shapes
               if name.endswith("kernel") and not name.startswith("LinearBias_")]
    sizes = [nets * int(np.prod(shapes[name])) for name in kernels]
    generator = torch.Generator(device=device).manual_seed(seed)
    draws = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(draws, 0.0, 1.0, -2.0, 2.0, generator=generator)
    params = {}
    for name, flat in zip(kernels, draws.split(sizes)):
        shape = shapes[name]
        std = float(np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978)
        params[name] = (flat * std).view((nets,) + shape)
    for name, shape in shapes.items():
        if name not in params:
            fill = 1.0 if name.endswith("scale") else 0.0
            params[name] = torch.full((nets,) + shape, fill, dtype=torch.float32, device=device)
    return params


def _batch_norm(x, scale, bias, axes):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(axes)
    var = torch.clamp(torch.mean(x * x, axes) - mean * mean, min=0.0)
    return ((x - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * scale).view(shape)
            + bias.view(shape))


def net_forward(config: dict, p: dict, images, forward_axis):
    """One net: images [B, H, W, C] float in [0, 1] -> [B, label dims]."""
    x = images.permute(0, 3, 1, 2)
    for i, (_, _, stride) in enumerate(conv_specs(config)):
        kernel = p[f"ConvBlock_{i}/Conv_0/kernel"].permute(3, 2, 0, 1)
        x = F.conv2d(x, kernel, p[f"ConvBlock_{i}/Conv_0/bias"], stride=stride)
        x = F.relu(_batch_norm(x, p[f"ConvBlock_{i}/BatchNorm_0/scale"],
                               p[f"ConvBlock_{i}/BatchNorm_0/bias"], [0, 2, 3]))
    x = x.permute(0, 2, 3, 1).flatten(1)
    for i in range(len(dense_widths(config))):
        x = x @ p[f"FcBlock_{i}/Dense_0/kernel"] + p[f"FcBlock_{i}/Dense_0/bias"]
        x = F.relu(_batch_norm(x, p[f"FcBlock_{i}/BatchNorm_0/scale"],
                               p[f"FcBlock_{i}/BatchNorm_0/bias"], [0]))
    out = x @ p["Dense_0/kernel"] + p["Dense_0/bias"]
    return out + forward_axis @ p["LinearBias_0/Dense_0/kernel"]


def sgd_steps(config: dict, params: dict, batches, learning_rate: float, lr_scale,
              on_step=None):
    """SGD steps of every net over ``batches`` (images uint8 [B, H, W, C],
    forward_axis [B, 3], labels [B, L'] tensors on the parameters' device).
    ``on_step(k, losses [N], grads, params)`` sees each step's losses, the
    gradients it took and the parameters after it. Returns the parameters
    after the last step."""
    nets = next(iter(params.values())).shape[0]
    trace = {name: torch.zeros_like(v) for name, v in params.items()}
    params = {name: v.clone() for name, v in params.items()}
    for k, (images, forward_axis, labels) in enumerate(batches):
        x = images.to(torch.float32) / 255.0
        losses, grads = [], {name: torch.empty_like(v) for name, v in params.items()}
        for n in range(nets):
            p = {name: v[n].detach().requires_grad_(True) for name, v in params.items()}
            pred = net_forward(config, p, x, forward_axis.to(torch.float32))
            per_example = ((pred - labels) ** 2).mean(-1)
            loss = per_example.mean()
            g = torch.autograd.grad(loss, list(p.values()))
            for name, gn in zip(p, g):
                grads[name][n] = gn
            losses.append(loss.detach())
        with torch.no_grad():
            scale = torch.as_tensor(lr_scale, dtype=torch.float32, device=x.device)
            for name in params:
                trace[name] = grads[name] + MOMENTUM * trace[name]
                factor = scale.view((-1,) + (1,) * (trace[name].dim() - 1))
                params[name] = params[name] + (-learning_rate * trace[name]) * factor
        if on_step is not None:
            on_step(k, torch.stack(losses), grads, params)
    return params
