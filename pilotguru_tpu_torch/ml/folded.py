"""The PilotNet ensemble folded into channels: N nets as one program (port
of pilotguru_tpu/ml/folded.py).

Each net's math is unchanged; the ensemble axis rides in the channels:

- conv1 sees the same image for every net, so it is one plain convolution
  with N * 24 outputs, the nets' kernels concatenated group-major;
- conv2 to conv5 are grouped convolutions (``groups=N``): each net's
  channels feed only its own;
- batch norm is per channel, so over the N * C folded channels it computes
  each net's own statistics; in train mode on the card, the batch norm, its
  cast to the compute dtype and the ReLU run as one hand-written kernel
  pair (ml/bn_relu_kernel.py), on the CPU as PyTorch ops (``_bn_train``);
- the fully connected layers are batched per-net products (``einsum`` over
  the net axis, a cuBLAS batched GEMM).

The parameters stay in the stacked per-net layout of the training state
(``[N, ...]`` leaves in the flax tree's names and layouts: HWIO conv
kernels, (in, out) dense kernels); the fold is a reshape inside the
forward, so gradients reach the per-net leaves. The trunk runs NCHW, and
each net's flatten keeps the flax (h, w, c) order. The convolutions and
products are cuDNN's and cuBLAS's, as the JAX package leaves them to XLA.

Dropout draws one mask over the folded channels from the given generator,
as the JAX package's folded path draws one over its folded channels. A
block of nets of a larger ensemble (the sharded train step, ml/training.py)
takes its slices of the whole ensemble's masks instead
(``ensemble_dropout_masks``, ``block_dropout_masks``), so each net keeps
the draws it has unsharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from pilotguru_tpu_torch.ml import bn_relu_kernel
from pilotguru_tpu_torch.ml import models as models_lib
from pilotguru_tpu_torch.utils import profiling

# Conv strides per block for each foldable trunk (kernel sizes and channel
# counts are read off the parameter shapes; strides are architecture).
_FOLDABLE_STRIDES = {
    models_lib.NVIDIA_NET_NAME: (2, 2, 2, 1, 1),
}

_BN_EPS = 1e-5  # flax nn.BatchNorm default
_BN_MOMENTUM = 0.9  # flax's convention


def foldable(model) -> bool:
    """True when the folded path computes this model (the PilotNet trunk)."""
    return (type(model).__name__ == "NvidiaSingleFrameNet"
            and model.options.get(models_lib.NET_NAME) in _FOLDABLE_STRIDES)


def fold_conv_kernel(k: torch.Tensor) -> torch.Tensor:
    """[N, kh, kw, cin, cout] (stacked HWIO) -> [N * cout, cin, kh, kw]
    (OIHW, group-major)."""
    n, kh, kw, cin, cout = k.shape
    return k.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, kh, kw)


def _wide(x):
    """x in float32, or wider: flax's batch norm computes in at least
    float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bn_train(x, reduce_axes, scale, bias, mean_ra, var_ra, shape):
    """Folded batch norm in train mode in float32, as the JAX package's
    folded path writes it: the biased batch variance normalises and
    updates. Returns (y, new_mean_ra, new_var_ra)."""
    xf = _wide(x)
    mean = xf.mean(reduce_axes)
    var = torch.clamp(torch.mean(xf * xf, reduce_axes) - mean * mean, min=0.0)
    y = ((xf - mean.view(shape)) * torch.rsqrt(var + _BN_EPS).view(shape) * scale.view(shape)
         + bias.view(shape))
    new_mean = _BN_MOMENTUM * mean_ra + (1.0 - _BN_MOMENTUM) * mean.detach()
    new_var = _BN_MOMENTUM * var_ra + (1.0 - _BN_MOMENTUM) * var.detach()
    return y, new_mean, new_var


def _bn_eval(x, scale, bias, mean_ra, var_ra, shape):
    xf = _wide(x)
    return ((xf - mean_ra.view(shape)) * torch.rsqrt(var_ra + _BN_EPS).view(shape)
            * scale.view(shape) + bias.view(shape))


def _dropout_mask(generator, shape, rate, dtype, device):
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - rate
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(dtype)


def _ordered(params, prefix):
    return sorted((k for k in params if k.startswith(prefix)),
                  key=lambda s: int(s.split("_")[1]))


def _dropout_prob(model, train: bool) -> float:
    return model.options.get(models_lib.DROPOUT_PROB, 0.0) if train else 0.0


def ensemble_dropout_masks(model, params: Dict, num_nets: int, batch: int,
                           generator: torch.Generator) -> List[torch.Tensor]:
    """The dropout masks ``folded_forward`` draws in train mode for an
    ensemble of ``num_nets`` nets shaped like ``params`` (the stacked
    trees of any block of it) on ``batch`` examples, in its order, from
    ``generator`` on its device: one [B, N * C, 1, 1] per conv block, then
    FcBlock_0's [B, N, G]. Empty when the model has no dropout."""
    p_drop = _dropout_prob(model, True)
    if p_drop <= 0:
        return []
    dtype = models_lib.resolve_compute_dtype(model.options, generator.device)
    shapes = [(batch, num_nets * params[name]["Conv_0"]["kernel"].shape[-1], 1, 1)
              for name in _ordered(params, "ConvBlock_")]
    fc0 = _ordered(params, "FcBlock_")[0]
    shapes.append((batch, num_nets, params[fc0]["Dense_0"]["kernel"].shape[-1]))
    return [_dropout_mask(generator, shape, p_drop, dtype, generator.device) for shape in shapes]


def block_dropout_masks(masks: List[torch.Tensor], num_nets: int, lo: int, hi: int,
                        device) -> List[torch.Tensor]:
    """Nets lo..hi's slices of ``ensemble_dropout_masks``, on ``device``."""
    out = []
    for mask in masks:
        if mask.dim() == 4:  # folded conv channels, net-major
            width = mask.shape[1] // num_nets
            out.append(mask[:, lo * width:hi * width].to(device))
        else:
            out.append(mask[:, lo:hi].to(device))
    return out


def folded_forward(model, params: Dict, batch_stats: Dict, inputs: Dict[str, torch.Tensor],
                   train: bool, generator: torch.Generator = None,
                   dropout_masks: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """Run the stacked-[N]-leaf ensemble as one folded program.

    model: the foldable net (its options and LinearBias inputs are read);
    params / batch_stats: stacked per-net trees; inputs: FRAME_IMG
    [B, H, W, C] float and the LinearBias inputs [B, D]; train: batch-norm
    and dropout mode; generator: dropout's draws (when its rate > 0 and
    train), or ``dropout_masks``, the masks themselves in draw order
    (``block_dropout_masks``). Returns (out [N, B, label_dims] in float32,
    or in the compute dtype where it is wider, and the new batch_stats
    stacked like the input's; the input's in eval mode)."""
    options = model.options
    blocks = options.get(models_lib.LAYER_BLOCKS_OPTIONS,
                         models_lib.DEFAULT_LAYER_BLOCKS_OPTIONS)
    conv_bn = blocks[models_lib.CONV][models_lib.BATCHNORM]
    fc_bn = blocks[models_lib.FC][models_lib.BATCHNORM]
    if (blocks[models_lib.CONV][models_lib.ACTIVATION] != models_lib.RELU
            or blocks[models_lib.FC][models_lib.ACTIVATION] != models_lib.RELU):
        raise NotImplementedError("folded path supports relu trunks only")
    p_drop = _dropout_prob(model, train)
    masks = iter(dropout_masks) if dropout_masks is not None else None

    def drop(x, shape):
        if masks is not None:
            return x * next(masks)
        return x * _dropout_mask(generator, shape, p_drop, x.dtype, x.device)

    frame = inputs[models_lib.FRAME_IMG]
    dtype = models_lib.resolve_compute_dtype(options, frame.device)
    strides = _FOLDABLE_STRIDES[options[models_lib.NET_NAME]]
    conv_names = _ordered(params, "ConvBlock_")
    fc_names = _ordered(params, "FcBlock_")
    assert len(conv_names) == len(strides), (conv_names, strides)
    n = params[conv_names[0]]["Conv_0"]["kernel"].shape[0]
    new_stats = {name: {k: dict(v) for k, v in block.items()}
                 for name, block in batch_stats.items()}

    def bn_relu(x, block_name, reduce_axes, shape):
        """relu(batch norm of x in float32, cast to the compute dtype). In
        train mode a CUDA tensor goes through the fused kernels
        (ml/bn_relu_kernel.py), a CPU tensor through ``_bn_train``."""
        bn_params = params[block_name]["BatchNorm_0"]
        stats = batch_stats[block_name]["BatchNorm_0"]
        scale, bias = bn_params["scale"].reshape(-1), bn_params["bias"].reshape(-1)
        mean_ra, var_ra = stats["mean"].reshape(-1), stats["var"].reshape(-1)
        if not train:
            return F.relu(_bn_eval(x, scale, bias, mean_ra, var_ra, shape).to(dtype))
        if x.is_cuda:
            profiling.count("folded.bn_fused")
            y, new_mean, new_var = bn_relu_kernel.bn_relu_train(
                x, scale, bias, mean_ra, var_ra, _BN_EPS, _BN_MOMENTUM)
        else:
            y, new_mean, new_var = _bn_train(x, reduce_axes, scale, bias, mean_ra, var_ra,
                                             shape)
            y = F.relu(y.to(dtype))
        per_net = stats["mean"].shape
        new_stats[block_name]["BatchNorm_0"] = {"mean": new_mean.reshape(per_net),
                                                "var": new_var.reshape(per_net)}
        return y

    # ------------------------------------------------------- conv trunk
    x = frame.permute(0, 3, 1, 2).to(dtype)
    for i, (name, stride) in enumerate(zip(conv_names, strides)):
        k = params[name]["Conv_0"]["kernel"]  # [N, kh, kw, cin, cout]
        b = params[name]["Conv_0"]["bias"]  # [N, cout]
        # Layer 1: every net reads the same image, a plain conv with the
        # kernels concatenated; later layers: block-diagonal groups.
        x = F.conv2d(x, fold_conv_kernel(k).to(dtype), b.reshape(-1).to(dtype),
                     stride=stride, groups=1 if i == 0 else n)
        x = bn_relu(x, name, (0, 2, 3), (1, -1, 1, 1)) if conv_bn else F.relu(x)
        if p_drop > 0:
            # DROPOUT_2D: whole channels (one draw per example and channel).
            x = drop(x, (x.shape[0], x.shape[1], 1, 1))

    # ------------------------------------------------- flatten per net
    bsz, nc, h, w = x.shape
    x = x.reshape(bsz, n, nc // n, h, w).permute(0, 1, 3, 4, 2).reshape(bsz, n, -1)

    # ------------------------------------------------------- FC trunk
    for j, name in enumerate(fc_names):
        wk = params[name]["Dense_0"]["kernel"].to(dtype)  # [N, F, G]
        wb = params[name]["Dense_0"]["bias"].to(dtype)  # [N, G]
        g = wk.shape[-1]
        x = torch.einsum("bnf,nfg->bng", x, wk) + wb[None]
        if fc_bn:
            x = bn_relu(x.reshape(bsz, n * g), name, (0,), (1, -1)).reshape(bsz, n, g)
        else:
            x = F.relu(x)
        # Only FcBlock_0 carries dropout (NvidiaSingleFrameNet gives the
        # others 0), one draw per activation.
        if p_drop > 0 and j == 0:
            x = drop(x, x.shape)

    # ------------------------------------------- label head + LinearBias
    wk = params["Dense_0"]["kernel"].to(dtype)  # [N, head, L]
    wb = params["Dense_0"]["bias"].to(dtype)  # [N, L]
    out = torch.einsum("bnf,nfl->bnl", x, wk) + wb[None]
    for idx, meta in enumerate(model.linear_bias_inputs):
        lb = params[f"LinearBias_{idx}"]["Dense_0"]["kernel"]  # [N, D, L]
        cond = inputs[meta["input_name"]].to(dtype)  # [B, D]
        out = out + torch.einsum("bd,ndl->bnl", cond, lb.to(dtype))
    return _wide(out.permute(1, 0, 2)), new_stats
