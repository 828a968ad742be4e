"""A plain Udacity Rambo ensemble: forward, loss, gradients and SGD, one net
after another, for the benchmark's comparison of training steps.

Team Rambo's winning model of Udacity's Self-Driving Car Challenge 2
(github.com/udacity/self-driving-car, steering-models/community-models/rambo)
as pilotguru's ``UdacityRamboNet`` (python/models.py) and the repository's
``rambo`` net state it. Three trunks read one frame:

- a comma.ai-style trunk: VALID convolutions of 16 (8x8, stride 4), 32 and
  64 channels (5x5, stride 2), then dense 512;
- an all-stride-2 PilotNet trunk: 24, 36 and 48 channels at 5x5, 64 and 64
  at 3x3, then dense 100 and 50;
- a four-conv trunk: 36 and 48 channels at 5x5, 64 and 64 at 3x3, all
  stride 2, then dense 100 and 50.

Every convolution and dense block is followed by batch norm and ReLU
(17 layers a net); each trunk ends in a plain dense layer to the head
width; the three heads are concatenated and go through one merge dense
layer to the label dimensions, plus a linear term of the ``forward_axis``
input without bias. The parameters are numbered as flax creates them, all
of one trunk before the next: ``ConvBlock_0-2``, ``3-7``, ``8-11``;
``FcBlock_0``, ``1-2``, ``3-4``; ``Dense_0-2`` for the trunk heads and
``Dense_3`` for the merge; stacked on a leading net axis, in flax's layouts.

Departures from the published description: pilotguru's class calls an
undefined ``MakeRelu``, which the repository reads as ReLU; the
``forward_axis`` term and the one output held against the dataset's two
steering labels are the repository's train CLI's, not the challenge's.

Batch norm in training uses the batch's biased variance computed as
mean(x^2) - mean(x)^2 (flax's), epsilon 1e-5. The loss of one net is the
mean over the batch of |prediction - label|^2 averaged over the labels;
SGD with momentum 0.9 (trace = g + 0.9 trace, step -lr * trace) times each
net's learning-rate factor. Plain torch only: this module imports nothing
of the program under test (nor, by the benchmark's rule for references,
anything of gpubench, so reference/pilotnet.py's helpers are repeated).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
MOMENTUM = 0.9


def _out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


def blocks(config: dict):
    """Each trunk as ([(conv block name, features, kernel, stride, (h, w) of
    its output)], [(FC block name, features)], its head's dense name, the
    flattened conv output's width), in flax's numbering."""
    out, conv_i, fc_i = [], 0, 0
    h0, w0, c0 = config["input_shape"]
    for t, trunk in enumerate(config["trunks"]):
        h, w, c = h0, w0, c0
        convs = []
        for features, kernel, stride in trunk["convs"]:
            h, w, c = _out(h, kernel, stride), _out(w, kernel, stride), features
            convs.append((f"ConvBlock_{conv_i}", features, kernel, stride, (h, w)))
            conv_i += 1
        fcs = []
        for features in trunk["dense"]:
            fcs.append((f"FcBlock_{fc_i}", features))
            fc_i += 1
        out.append((convs, fcs, f"Dense_{t}", h * w * c))
    return out


def merge_name(config: dict) -> str:
    return f"Dense_{len(config['trunks'])}"


def layer_shapes(config: dict) -> dict:
    """{flat leaf name: one net's shape} of the parameter tree."""
    shapes = {}
    head = config["head_dims"]
    for convs, fcs, head_name, flat in blocks(config):
        c = config["input_shape"][2]
        for name, features, kernel, _, _ in convs:
            shapes[f"{name}/Conv_0/kernel"] = (kernel, kernel, c, features)
            shapes[f"{name}/Conv_0/bias"] = (features,)
            shapes[f"{name}/BatchNorm_0/scale"] = (features,)
            shapes[f"{name}/BatchNorm_0/bias"] = (features,)
            c = features
        n = flat
        for name, features in fcs:
            shapes[f"{name}/Dense_0/kernel"] = (n, features)
            shapes[f"{name}/Dense_0/bias"] = (features,)
            shapes[f"{name}/BatchNorm_0/scale"] = (features,)
            shapes[f"{name}/BatchNorm_0/bias"] = (features,)
            n = features
        shapes[f"{head_name}/kernel"] = (n, head)
        shapes[f"{head_name}/bias"] = (head,)
    merge = merge_name(config)
    shapes[f"{merge}/kernel"] = (len(config["trunks"]) * head, config["label_dimensions"])
    shapes[f"{merge}/bias"] = (config["label_dimensions"],)
    shapes["LinearBias_0/Dense_0/kernel"] = (config["bias_input_dims"],
                                            config["label_dimensions"])
    return dict(sorted(shapes.items(), key=lambda kv: _flax_order(kv[0])))


def _flax_order(name: str):
    """Conv blocks, then FC blocks, then dense layers, each by index, then
    LinearBias: the order of reference/pilotnet.py's leaves, in which
    ``initial_params`` draws the kernels."""
    top = name.split("/")[0]
    kind, index = top.rsplit("_", 1)
    rank = ("ConvBlock", "FcBlock", "Dense", "LinearBias").index(kind)
    return rank, int(index), name.split("/")[1:]


def batch_norm_sizes(config: dict) -> list:
    """(block name, values a net-example, channels) of each train-mode
    batch norm of a net, trunk by trunk: a conv block's output h * w * C,
    a dense block's C."""
    out = []
    for convs, fcs, _, _ in blocks(config):
        out += [(name, h * w * f, f) for name, f, _, _, (h, w) in convs]
        out += [(name, f, f) for name, f in fcs]
    return out


def forward_flops(config: dict) -> int:
    """Multiply-adds of one net's forward pass on one example, counted twice
    (a multiply and an add), over the convolutions and the dense layers."""
    flops = 0
    for convs, fcs, _, flat in blocks(config):
        c = config["input_shape"][2]
        for _, features, kernel, _, (h, w) in convs:
            flops += 2 * h * w * features * kernel * kernel * c
            c = features
        n = flat
        for _, features in fcs + [(None, config["head_dims"])]:
            flops += 2 * n * features
            n = features
    flops += 2 * len(config["trunks"]) * config["head_dims"] * config["label_dimensions"]
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


def _batch_norm_relu(x, p, name, moments, running):
    """relu(batch norm of x) over every axis but the channel's: the batch's
    statistics, or ``running[name]`` (mean, var) where given (eval mode);
    the batch's (mean, var) go into ``moments`` where it is a dict."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if running is not None:
        mean, var = running[name]
    else:
        mean = x.mean(axes)
        var = torch.clamp(torch.mean(x * x, axes) - mean * mean, min=0.0)
        if moments is not None:
            moments[name] = (mean, var)
    scale, bias = p[f"{name}/BatchNorm_0/scale"], p[f"{name}/BatchNorm_0/bias"]
    return F.relu((x - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * scale).view(shape)
                  + bias.view(shape))


def net_forward(config: dict, p: dict, images, forward_axis, masks=None, moments=None,
                running=None):
    """One net: images [B, H, W, C] float in [0, 1] -> [B, label dims].

    masks: {block name: dropout mask}, multiplied in after the block's
    ReLU ([B, C, 1, 1] for a conv block, [B, G] for a dense one); moments:
    a dict that receives each block's batch (mean, var); running: {block
    name: (mean, var)} to normalise with instead (eval mode)."""
    masks = masks or {}
    frame = images.permute(0, 3, 1, 2)
    heads = []
    for convs, fcs, head_name, _ in blocks(config):
        x = frame
        for name, _, _, stride, _ in convs:
            kernel = p[f"{name}/Conv_0/kernel"].permute(3, 2, 0, 1)
            x = F.conv2d(x, kernel, p[f"{name}/Conv_0/bias"], stride=stride)
            x = _batch_norm_relu(x, p, name, moments, running)
            if name in masks:
                x = x * masks[name]
        x = x.permute(0, 2, 3, 1).flatten(1)
        for name, _ in fcs:
            x = x @ p[f"{name}/Dense_0/kernel"] + p[f"{name}/Dense_0/bias"]
            x = _batch_norm_relu(x, p, name, moments, running)
            if name in masks:
                x = x * masks[name]
        heads.append(x @ p[f"{head_name}/kernel"] + p[f"{head_name}/bias"])
    merge = merge_name(config)
    out = torch.cat(heads, dim=1) @ p[f"{merge}/kernel"] + p[f"{merge}/bias"]
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
            loss = ((pred - labels) ** 2).mean(-1).mean()
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
