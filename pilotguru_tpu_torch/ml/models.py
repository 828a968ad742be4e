"""The steering-model zoo as torch ``nn.Module``s (port of
pilotguru_tpu/ml/models.py, itself the reference's python/models.py).

Same network names, option keys and defaults, so settings JSONs and flax
checkpoints (``ml/convert.py``) carry across. In PyTorch idiom:

- Inputs are the JAX package's: a dict {input_name: array}, the frame
  ``[B, H, W, C]`` (NHWC) float. The trunk runs NCHW, and ``_flatten``
  flattens in the JAX order, (H, W, C), so the first dense layer's weights
  are the flax kernel transposed, with no permutation of its rows.
- The image shape is given when the net is built (``make_network``'s
  ``input_shape``): torch layers need their input widths, flax infers them.
- Conv padding is VALID (0). Batch norm: epsilon 1e-5 and momentum 0.1 in
  torch's convention (flax's 0.9), computed in float32 and cast back to the
  compute dtype, as the JAX package's blocks do. In train mode
  (``net.train()``) it is flax's, written out rather than taken from
  ``nn.BatchNorm``: the batch's one-pass biased variance
  ``mean(x^2) - mean(x)^2``, clamped at 0, normalises and updates the
  running variance (torch's would update with the unbiased one), and the
  running statistics move as ``0.9 * running + (1 - 0.9) * batch``.
- Dropout (train mode only) draws its masks from the ``generator`` given to
  ``forward``, never from the global generator: ``2d`` drops whole
  channels, ``vanilla`` single activations, ``alpha`` is SELU's.
- ``compute_dtype``: the convs and the blocks' dense layers compute in
  ``resolve_compute_dtype`` (bfloat16 on CUDA, the accelerator default the
  JAX package gives its TPU; float32 on the CPU) by an explicit cast;
  parameters stay float32, and so do the layers outside the blocks (flax's
  promotion of a bfloat16 input with float32 parameters). TF32 stays off
  (pilotguru_tpu_torch/__init__.py).
- Module attributes mirror the flax names: ``conv_blocks[i]`` is
  ``ConvBlock_i``, ``fc_blocks[i]`` ``FcBlock_i``, ``denses[i]``
  ``Dense_i``, ``linear_biases[i]`` ``LinearBias_i``, numbered in the
  order flax creates them.
- UdacityRamboNet: the reference's class calls an undefined MakeRelu; ReLU
  blocks, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Options dict keys (match the reference so settings JSONs round-trip).
CONV = "conv"
FC = "fc"
ACTIVATION = "activation"
RELU = "relu"
SELU = "selu"
DROPOUT = "dropout"
DROPOUT_VANILLA = "vanilla"
DROPOUT_2D = "2d"
DROPOUT_ALPHA = "alpha"
DROPOUT_PROB = "dropout_prob"
BATCHNORM = "batchnorm"

FORWARD_AXIS = "forward_axis"
FRAME_IMG = "frame_img"
STEERING = "steering"
RECORDING_ID = "recording_id"

NET_NAME = "net_name"
NET_HEAD_DIMS = "net_head_dims"
LABEL_DIMENSIONS = "label_dimensions"
LAYER_BLOCKS_OPTIONS = "layer_blocks_options"
# The JAX package's extension: the conv / dense compute precision
# ("bfloat16" or "float32"); unset, bfloat16 on the accelerator.
COMPUTE_DTYPE = "compute_dtype"

TOY_NET_NAME = "toy"
NVIDIA_NET_NAME = "nvidia"
RAMBO_NET_NAME = "rambo"
RAMBO_COMMA_NET_NAME = "rambo-comma"
RAMBO_NVIDIA_DEEP_NET_NAME = "rambo-nvidia-deep"
RAMBO_NVIDIA_SHALLOW_NET_NAME = "rambo-nvidia-shallow"
DEEP_NVIDIA_NET_NAME = "nvidia-deep"

# train.py:43-53 defaults.
DEFAULT_LAYER_BLOCKS_OPTIONS = {
    CONV: {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_2D},
    FC: {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_VANILLA},
}

# flax.linen.BatchNorm's defaults, in torch's terms.
BATCHNORM_EPS = 1e-5
BATCHNORM_MOMENTUM = 0.1


def resolve_compute_dtype(options: Dict[str, Any], device) -> torch.dtype:
    """Computation dtype of the conv / dense blocks on ``device`` (see
    COMPUTE_DTYPE): the option when set, else bfloat16 on CUDA and float32
    on the CPU."""
    name = options.get(COMPUTE_DTYPE)
    if name is None:
        name = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _activation(name: str):
    if name == RELU:
        return F.relu
    if name == SELU:
        return F.selu
    raise ValueError(f"unknown activation type: {name}")


# flax.linen.BatchNorm's momentum in flax's convention, for the train-mode
# update of the running statistics.
FLAX_BATCHNORM_MOMENTUM = 0.9
# -scale * alpha of SELU (the JAX package's AlphaDropout).
_ALPHA_PRIME = -1.7580993408473766


def dropout(x: torch.Tensor, kind: str, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Dropout of an NCHW or [B, F] activation with masks from
    ``generator``: flax's nn.Dropout (kept values divided by the keep
    probability), ``2d`` with one draw per (example, channel), or the JAX
    package's AlphaDropout."""
    if kind not in (DROPOUT_VANILLA, DROPOUT_2D, DROPOUT_ALPHA):
        raise ValueError(f"unknown dropout type: {kind}")
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if kind == DROPOUT_2D else x.shape
    # Drawn on the generator's device, so that nets of a sharded ensemble
    # on other devices take the draws they take unsharded (ml/training.py).
    mask = (torch.rand(shape, generator=generator, device=generator.device) < keep).to(x.device)
    if kind == DROPOUT_ALPHA:
        a = (keep + _ALPHA_PRIME ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * _ALPHA_PRIME * (1 - keep)
        return a * torch.where(mask, x, torch.full_like(x, _ALPHA_PRIME)) + b
    return torch.where(mask, x / keep, torch.zeros_like(x))


def batch_norm_train(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """flax's train-mode BatchNorm of a float32 NCHW or [B, F] activation
    over every axis but the channel's: normalises with the batch statistics
    and updates ``bn``'s running statistics in place (no gradient)."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(axes)
    var = torch.clamp(torch.mean(x * x, axes) - mean * mean, min=0.0)
    with torch.no_grad():
        m = FLAX_BATCHNORM_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class _Block(nn.Module):
    """Layer -> [BatchNorm (float32)] -> activation -> [dropout]
    (models.py:133-155); ``layer`` is a Conv2d or a Linear, run in the
    compute dtype given at call time."""

    def __init__(self, layer: nn.Module, bn: nn.Module, options: Dict[str, Any],
                 dropout_prob: float):
        super().__init__()
        self.layer = layer
        self.bn = bn if options[BATCHNORM] else None
        self.act = _activation(options[ACTIVATION])
        self.dropout_kind = options[DROPOUT]
        self.dropout_prob = dropout_prob

    def _apply_layer(self, x, dtype):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: torch.Generator = None) -> torch.Tensor:
        x = self._apply_layer(x.to(dtype), dtype)
        if self.bn is not None:
            x = (batch_norm_train(x.float(), self.bn) if self.training
                 else self.bn(x.float())).to(dtype)
        x = self.act(x)
        if self.training and self.dropout_prob > 0:
            x = dropout(x, self.dropout_kind, self.dropout_prob, generator)
        return x


class ConvBlock(_Block):
    def __init__(self, in_channels: int, features: int, kernel: int, stride: int,
                 options: Dict[str, Any], dropout_prob: float):
        super().__init__(
            nn.Conv2d(in_channels, features, kernel, stride=stride, padding=0),
            nn.BatchNorm2d(features, eps=BATCHNORM_EPS, momentum=BATCHNORM_MOMENTUM),
            options, dropout_prob)

    def _apply_layer(self, x, dtype):
        conv = self.layer
        return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=conv.stride)


class FcBlock(_Block):
    def __init__(self, in_features: int, features: int, options: Dict[str, Any],
                 dropout_prob: float):
        super().__init__(
            nn.Linear(in_features, features),
            nn.BatchNorm1d(features, eps=BATCHNORM_EPS, momentum=BATCHNORM_MOMENTUM),
            options, dropout_prob)

    def _apply_layer(self, x, dtype):
        return F.linear(x, self.layer.weight.to(dtype), self.layer.bias.to(dtype))


class LinearBias(nn.Module):
    """Zero-initialised linear conditioning added to the net output, no bias
    term (models.py:170-183)."""

    def __init__(self, in_dims: int, out_dims: int, input_name: str):
        super().__init__()
        self.input_name = input_name
        self.dense = nn.Linear(in_dims, out_dims, bias=False)
        nn.init.zeros_(self.dense.weight)

    def forward(self, pre_bias, inputs):
        return pre_bias + self.dense(inputs[self.input_name].float())


class Trunk(NamedTuple):
    """One image trunk of a net, by the indices flax numbers its blocks
    with: ``convs`` into conv_blocks, ``fcs`` into fc_blocks, then ``head``
    into denses, the trunk's own dense layer (None where the FC blocks end
    the trunk). A net's trunks read the same frame; their outputs are
    concatenated into its last dense layer."""

    convs: range
    fcs: range
    head: Optional[int]


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H * W * C] in the JAX package's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).flatten(1)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A dense layer outside the blocks: float32, as flax promotes a
    bfloat16 input with float32 parameters."""
    return layer(x.float())


class _ImageNetBase(nn.Module):
    """Shared plumbing: the image trunk's bookkeeping and the LinearBias
    post-transforms."""

    def __init__(self, options: Dict[str, Any], linear_bias_inputs: Sequence[Dict[str, Any]],
                 input_shape: Tuple[int, int, int]):
        super().__init__()
        self.options = options
        self.linear_bias_inputs = tuple(linear_bias_inputs)
        self.input_shape = tuple(input_shape)
        self.conv_blocks = nn.ModuleList()
        self.fc_blocks = nn.ModuleList()
        self.denses = nn.ModuleList()
        self.linear_biases = nn.ModuleList(
            LinearBias(int(m["input_dims"]), options[LABEL_DIMENSIONS], m["input_name"])
            for m in self.linear_bias_inputs)

    @property
    def _blocks(self):
        return self.options.get(LAYER_BLOCKS_OPTIONS, DEFAULT_LAYER_BLOCKS_OPTIONS)

    @property
    def _dropout_prob(self):
        return self.options.get(DROPOUT_PROB, 0.0)

    def _convs(self, specs, shape, dropout_prob, blocks=None):
        """Append a ConvBlock per (features, kernel, stride) to
        conv_blocks; returns the trunk's output (H, W, C)."""
        h, w, c = shape
        for features, kernel, stride in specs:
            self.conv_blocks.append(ConvBlock(c, features, kernel, stride,
                                              blocks or self._blocks[CONV], dropout_prob))
            h, w, c = _conv_out(h, kernel, stride), _conv_out(w, kernel, stride), features
        if h <= 0 or w <= 0:
            raise ValueError(f"input {self.input_shape} shrinks to nothing in "
                             f"{self.options[NET_NAME]}'s convolutions")
        return h, w, c

    def _fcs(self, in_features, specs, blocks=None):
        """Append an FcBlock per (features, dropout_prob) to fc_blocks."""
        for features, p in specs:
            self.fc_blocks.append(FcBlock(in_features, features, blocks or self._blocks[FC], p))
            in_features = features
        return in_features

    def _frame(self, inputs):
        """The frame, NHWC -> NCHW float32; and the compute dtype."""
        x = inputs[FRAME_IMG]
        return x.permute(0, 3, 1, 2).float(), resolve_compute_dtype(self.options, x.device)

    def _post(self, out, inputs):
        for bias in self.linear_biases:
            out = bias(out, inputs)
        return out

    def _trunks_forward(self, inputs, generator):
        """The forward of a net described by ``self.trunks``: each trunk's
        conv blocks, flatten, FC blocks and head dense; the trunks'
        outputs concatenated through the last dense layer."""
        frame, dt = self._frame(inputs)
        outs = []
        for trunk in self.trunks:
            x = frame
            for i in trunk.convs:
                x = self.conv_blocks[i](x, dt, generator)
            x = _flatten(x)
            for i in trunk.fcs:
                x = self.fc_blocks[i](x, dt, generator)
            outs.append(x if trunk.head is None else _dense(x, self.denses[trunk.head]))
        return self._post(_dense(torch.cat(outs, dim=1), self.denses[-1]), inputs)


class ToyConvNet(_ImageNetBase):
    """3-conv + 3-fc debugging net (models.py:218-242)."""

    def __init__(self, options, linear_bias_inputs, input_shape):
        super().__init__(options, linear_bias_inputs, input_shape)
        h, w, c = input_shape
        for features in (6, 16, 1):
            self._convs([(features, 5, 1)], (h, w, c), 0.0)
            h, w, c = _conv_out(h, 5, 1) // 2, _conv_out(w, 5, 1) // 2, features
        dims = [h * w * c, 120, 84, 1]
        self.denses.extend(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, inputs, generator: torch.Generator = None):
        x, dt = self._frame(inputs)
        for block in self.conv_blocks:
            x = F.max_pool2d(block(x, dt, generator), 2, 2)
        x = _flatten(x)
        act = _activation(self._blocks[FC][ACTIVATION])
        x = act(_dense(x, self.denses[0]))
        x = act(_dense(x, self.denses[1]))
        return self._post(_dense(x, self.denses[2]), inputs)


class NvidiaSingleFrameNet(_ImageNetBase):
    """NVIDIA PilotNet: conv 24-36-48-64-64, fc 1164-100-50-head-labels
    (models.py:245-279)."""

    def __init__(self, options, linear_bias_inputs, input_shape):
        super().__init__(options, linear_bias_inputs, input_shape)
        p, head = self._dropout_prob, options[NET_HEAD_DIMS]
        h, w, c = self._convs([(24, 5, 2), (36, 5, 2), (48, 5, 2), (64, 3, 1), (64, 3, 1)],
                              input_shape, p)
        n = self._fcs(h * w * c, [(1164, p), (max(100, head), 0.0), (max(50, head), 0.0),
                                  (head, 0.0)])
        self.denses.append(nn.Linear(n, options[LABEL_DIMENSIONS]))
        self.trunks = (Trunk(range(len(self.conv_blocks)), range(len(self.fc_blocks)), None),)

    def forward(self, inputs, generator: torch.Generator = None):
        return self._trunks_forward(inputs, generator)


class RamboCommaNet(_ImageNetBase):
    """comma.ai-style branch of the Udacity Rambo model (models.py:423-454)."""

    def __init__(self, options, linear_bias_inputs, input_shape):
        super().__init__(options, linear_bias_inputs, input_shape)
        p = self._dropout_prob
        h, w, c = self._convs([(16, 8, 4), (32, 5, 2), (64, 5, 2)], input_shape, p)
        n = self._fcs(h * w * c, [(512, p)])
        self.denses.append(nn.Linear(n, options[NET_HEAD_DIMS]))
        self.denses.append(nn.Linear(options[NET_HEAD_DIMS], options[LABEL_DIMENSIONS]))

    def forward(self, inputs, generator: torch.Generator = None):
        x, dt = self._frame(inputs)
        for block in self.conv_blocks:
            x = block(x, dt, generator)
        x = self.fc_blocks[0](_flatten(x), dt, generator)
        x = F.relu(_dense(x, self.denses[0]))
        return self._post(_dense(x, self.denses[1]), inputs)


class RamboNVidiaNet(_ImageNetBase):
    """NVIDIA-style Rambo branch, all-stride-2 convs (models.py:457-498)."""

    def __init__(self, options, linear_bias_inputs, input_shape,
                 skip_first_conv_layer: bool = False):
        super().__init__(options, linear_bias_inputs, input_shape)
        p, head = self._dropout_prob, options[NET_HEAD_DIMS]
        specs = [(36, 5, 2), (48, 5, 2), (64, 3, 2), (64, 3, 2)]
        if not skip_first_conv_layer:
            specs.insert(0, (24, 5, 2))
        h, w, c = self._convs(specs, input_shape, p)
        n = self._fcs(h * w * c, [(1164, p), (max(100, head), 0.0)])
        self.denses.append(nn.Linear(n, head))
        self.denses.append(nn.Linear(head, options[LABEL_DIMENSIONS]))

    def forward(self, inputs, generator: torch.Generator = None):
        x, dt = self._frame(inputs)
        for block in self.conv_blocks:
            x = block(x, dt, generator)
        x = _flatten(x)
        for block in self.fc_blocks:
            x = block(x, dt, generator)
        x = F.relu(_dense(x, self.denses[0]))
        return self._post(_dense(x, self.denses[1]), inputs)


class DeepNVidiaNet(_ImageNetBase):
    """8-conv deep PilotNet variant (models.py:501-542)."""

    def __init__(self, options, linear_bias_inputs, input_shape):
        super().__init__(options, linear_bias_inputs, input_shape)
        p, head = self._dropout_prob, options[NET_HEAD_DIMS]
        h, w, c = self._convs([(36, 5, 2), (48, 5, 2), (48, 5, 1), (64, 3, 1),
                               (64, 3, 2), (64, 3, 1), (64, 3, 1), (64, 3, 1)], input_shape, p)
        n = self._fcs(h * w * c, [(1164, p), (max(100, head), p)])
        self.denses.append(nn.Linear(n, head))
        self.denses.append(nn.Linear(head, options[LABEL_DIMENSIONS]))

    def forward(self, inputs, generator: torch.Generator = None):
        x, dt = self._frame(inputs)
        for block in self.conv_blocks:
            x = block(x, dt, generator)
        x = _flatten(x)
        for block in self.fc_blocks:
            x = block(x, dt, generator)
        x = _activation(self._blocks[FC][ACTIVATION])(_dense(x, self.denses[0]))
        return self._post(_dense(x, self.denses[1]), inputs)


class UdacityRamboNet(_ImageNetBase):
    """Three-branch ensemble-in-one (comma + 2 NVIDIA-ish) (models.py:282-420);
    the branch outputs concatenate into one linear merge layer."""

    _BRANCHES = (
        ([(16, 8, 4), (32, 5, 2), (64, 5, 2)], [512]),
        ([(24, 5, 2), (36, 5, 2), (48, 5, 2), (64, 3, 2), (64, 3, 2)], [100, 50]),
        ([(36, 5, 2), (48, 5, 2), (64, 3, 2), (64, 3, 2)], [100, 50]),
    )

    def __init__(self, options, linear_bias_inputs, input_shape):
        super().__init__(options, linear_bias_inputs, input_shape)
        p, head = self._dropout_prob, options[NET_HEAD_DIMS]
        conv = {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_2D}
        fc = {BATCHNORM: True, ACTIVATION: RELU, DROPOUT: DROPOUT_VANILLA}
        # flax numbers ConvBlock_i, FcBlock_i and Dense_i across the three
        # branches in creation order: all of one branch, then the next.
        trunks = []
        for convs, fcs in self._BRANCHES:
            c0, f0 = len(self.conv_blocks), len(self.fc_blocks)
            h, w, c = self._convs(convs, input_shape, p, conv)
            n = self._fcs(h * w * c, [(f, p if i == 0 else 0.0) for i, f in enumerate(fcs)], fc)
            self.denses.append(nn.Linear(n, head))
            trunks.append(Trunk(range(c0, len(self.conv_blocks)),
                                range(f0, len(self.fc_blocks)), len(self.denses) - 1))
        self.trunks = tuple(trunks)
        self.denses.append(nn.Linear(3 * head, options[LABEL_DIMENSIONS]))

    def forward(self, inputs, generator: torch.Generator = None):
        return self._trunks_forward(inputs, generator)


def make_network(options: Dict[str, Any], linear_bias_inputs=(),
                 input_shape: Tuple[int, int, int] = (66, 200, 3)) -> _ImageNetBase:
    """Factory matching MakeNetwork (models.py:552-572), same net names;
    ``input_shape``: the frame's (height, width, channels)."""
    net_name = options[NET_NAME]
    classes = {
        TOY_NET_NAME: ToyConvNet,
        NVIDIA_NET_NAME: NvidiaSingleFrameNet,
        RAMBO_NET_NAME: UdacityRamboNet,
        RAMBO_COMMA_NET_NAME: RamboCommaNet,
        DEEP_NVIDIA_NET_NAME: DeepNVidiaNet,
    }
    if net_name in classes:
        return classes[net_name](options, linear_bias_inputs, input_shape)
    if net_name in (RAMBO_NVIDIA_DEEP_NET_NAME, RAMBO_NVIDIA_SHALLOW_NET_NAME):
        return RamboNVidiaNet(options, linear_bias_inputs, input_shape,
                              skip_first_conv_layer=net_name == RAMBO_NVIDIA_SHALLOW_NET_NAME)
    raise ValueError(f"Unknown network name: {net_name}")
