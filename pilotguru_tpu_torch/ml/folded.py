"""A foldable net's ensemble folded into channels: N nets as one program
(port of pilotguru_tpu/ml/folded.py, which folds the PilotNet trunk).

A foldable net (PilotNet, the Udacity Rambo net, with ReLU blocks) is its
trunks (``model.trunks``, ml/models.py): each reads the frame through conv blocks,
flattens and runs FC blocks, then, in Rambo, its own dense head; the
trunks' outputs are concatenated into the net's last dense layer. Each
net's math is unchanged; the ensemble axis rides in the channels:

- a trunk's first conv sees the same image for every net, so it is one
  plain convolution with N * C outputs, the nets' kernels concatenated
  group-major;
- its later convs are grouped convolutions (``groups=N``): each net's
  channels feed only its own;
- batch norm is per channel, so over the N * C folded channels it computes
  each net's own statistics; a block's batch norm, its cast to the compute
  dtype and the ReLU are one call of ml/bn_relu_kernel.py, which runs them
  as a hand-written kernel pair in train mode on the card;
- the dense layers are batched per-net products (``einsum`` over the net
  axis, a cuBLAS batched GEMM);
- each conv is one call of ml/conv_kernel.py, which in train mode on the
  card in float32 takes its backward (the input's, the weights' and the
  bias's gradients) through a hand-written kernel pair, its forward cuDNN's
  convolution as elsewhere.

Strides, dropout rates and whether a block has batch norm are read off the
model's blocks; kernel sizes and channel counts off the parameter shapes.
The parameters stay in the stacked per-net layout of the training state
(``[N, ...]`` leaves in the flax tree's names and layouts: HWIO conv
kernels, (in, out) dense kernels); the fold is a reshape inside the
forward, so gradients reach the per-net leaves. The trunks run NCHW, and
each net's flatten keeps the flax (h, w, c) order. The convolutions (but
the float32 train-mode backward on the card) and products are cuDNN's and
cuBLAS's, as the JAX package leaves them to XLA.

Dropout masks are drawn from the given generator over the folded channels,
one for each block with a dropout rate, all before the forward runs, in
``ensemble_dropout_masks``' order (the conv blocks, then the FC blocks, each
by its flax index). A block of nets of a larger ensemble (the sharded train
step, ml/training.py) takes its slices of the whole ensemble's masks
instead (``block_dropout_masks``), so each net keeps the draws it has
unsharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from pilotguru_tpu_torch.ml import bn_relu_kernel, conv_kernel
from pilotguru_tpu_torch.ml import models as models_lib

_BN_EPS = 1e-5  # flax nn.BatchNorm default
_BN_MOMENTUM = 0.9  # flax's convention


def foldable(model) -> bool:
    """True when the folded path computes this model: a net of trunks
    (PilotNet, the Udacity Rambo net) whose blocks all take a ReLU and,
    where a block drops out, drop whole channels after a conv and single
    activations after a dense layer."""
    if getattr(model, "trunks", None) is None:
        return False
    kinds = [(b, models_lib.DROPOUT_2D) for b in model.conv_blocks]
    kinds += [(b, models_lib.DROPOUT_VANILLA) for b in model.fc_blocks]
    return all(b.act is F.relu and (b.dropout_prob == 0 or b.dropout_kind == kind)
               for b, kind in kinds)


def _dropout_mask(generator, shape, rate, dtype, device):
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - rate
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(dtype)


def _dropout_blocks(model) -> List[Tuple[str, float]]:
    """(flax name, dropout rate) of each block that drops out in train
    mode, in the masks' order: the conv blocks, then the FC blocks, each by
    its index."""
    return ([(f"ConvBlock_{i}", b.dropout_prob) for i, b in enumerate(model.conv_blocks)
             if b.dropout_prob > 0]
            + [(f"FcBlock_{j}", b.dropout_prob) for j, b in enumerate(model.fc_blocks)
               if b.dropout_prob > 0])


def ensemble_dropout_masks(model, params: Dict, num_nets: int, batch: int,
                           generator: torch.Generator) -> List[torch.Tensor]:
    """The dropout masks ``folded_forward`` takes in train mode for an
    ensemble of ``num_nets`` nets shaped like ``params`` (the stacked
    trees of any block of it) on ``batch`` examples, in
    ``_dropout_blocks``' order, from ``generator`` on its device: a
    [B, N * C, 1, 1] for a conv block (whole channels), a [B, N, G] for an
    FC block. Empty when the model has no dropout."""
    blocks = _dropout_blocks(model)
    if not blocks:
        return []
    dtype = models_lib.resolve_compute_dtype(model.options, generator.device)
    masks = []
    for name, rate in blocks:
        if name.startswith("ConvBlock_"):
            shape = (batch, num_nets * params[name]["Conv_0"]["kernel"].shape[-1], 1, 1)
        else:
            shape = (batch, num_nets, params[name]["Dense_0"]["kernel"].shape[-1])
        masks.append(_dropout_mask(generator, shape, rate, dtype, generator.device))
    return masks


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

    model: the foldable net (its trunks, blocks, options and LinearBias
    inputs are read); params / batch_stats: stacked per-net trees; inputs:
    FRAME_IMG [B, H, W, C] float and the LinearBias inputs [B, D]; train:
    batch-norm and dropout mode; generator: dropout's draws (when a rate is
    above 0 and train), or ``dropout_masks``, the masks themselves
    (``ensemble_dropout_masks``, ``block_dropout_masks``). Returns (out
    [N, B, label_dims] in float32, or in the compute dtype where it is
    wider, and the new batch_stats stacked like the input's; the input's in
    eval mode)."""
    if not foldable(model):
        raise NotImplementedError("the folded path computes the nets `foldable` takes only")
    frame = inputs[models_lib.FRAME_IMG]
    dtype = models_lib.resolve_compute_dtype(model.options, frame.device)
    n = params["ConvBlock_0"]["Conv_0"]["kernel"].shape[0]
    bsz = frame.shape[0]
    masks = {}
    if train:
        if dropout_masks is None:
            dropout_masks = ensemble_dropout_masks(model, params, n, bsz, generator)
        masks = {name: m for (name, _), m in zip(_dropout_blocks(model), dropout_masks)}
    new_stats = {name: {k: dict(v) for k, v in block.items()}
                 for name, block in batch_stats.items()}

    def bn_relu(x, block_name):
        """relu(batch norm of x in float32, cast to the compute dtype),
        keeping the block's new running statistics in train mode."""
        bn_params = params[block_name]["BatchNorm_0"]
        stats = batch_stats[block_name]["BatchNorm_0"]
        y, new_mean, new_var = bn_relu_kernel.block_bn_relu(
            x, bn_params["scale"].reshape(-1), bn_params["bias"].reshape(-1),
            stats["mean"].reshape(-1), stats["var"].reshape(-1), _BN_EPS, _BN_MOMENTUM, train,
            dtype)
        if train:
            per_net = stats["mean"].shape
            new_stats[block_name]["BatchNorm_0"] = {"mean": new_mean.reshape(per_net),
                                                    "var": new_var.reshape(per_net)}
        return y

    def dense(x, layer):
        """x [B, N, F] through the per-net dense ``layer`` (its stacked
        parameters): [B, N, G]."""
        wk = layer["kernel"].to(dtype)  # [N, F, G]
        wb = layer["bias"].to(dtype)  # [N, G]
        return torch.einsum("bnf,nfg->bng", x, wk) + wb[None]

    image = frame.permute(0, 3, 1, 2).to(dtype)
    outs = []
    for trunk in model.trunks:
        # --------------------------------------------------- conv blocks
        x = image
        for pos, i in enumerate(trunk.convs):
            name, block = f"ConvBlock_{i}", model.conv_blocks[i]
            k = params[name]["Conv_0"]["kernel"]  # [N, kh, kw, cin, cout]
            b = params[name]["Conv_0"]["bias"]  # [N, cout]
            # The trunk's first conv: every net reads the same image, a
            # plain conv with the kernels concatenated; later convs:
            # block-diagonal groups.
            groups = 1 if pos == 0 else n
            x = conv_kernel.block_conv(x, k, b, block.layer.stride, groups, train, dtype)
            x = bn_relu(x, name) if block.bn is not None else F.relu(x)
            if name in masks:
                x = x * masks[name]  # DROPOUT_2D: whole channels

        # --------------------------------------------- flatten per net
        _, nc, h, w = x.shape
        x = x.reshape(bsz, n, nc // n, h, w).permute(0, 1, 3, 4, 2).reshape(bsz, n, -1)

        # ----------------------------------------------------- FC blocks
        for j in trunk.fcs:
            name = f"FcBlock_{j}"
            x = dense(x, params[name]["Dense_0"])
            g = x.shape[-1]
            if model.fc_blocks[j].bn is not None:
                x = bn_relu(x.reshape(bsz, n * g), name).reshape(bsz, n, g)
            else:
                x = F.relu(x)
            if name in masks:
                x = x * masks[name]  # one draw per activation
        if trunk.head is not None:
            x = dense(x, params[f"Dense_{trunk.head}"])
        outs.append(x)

    # ----------------------------------- merge (label head) + LinearBias
    out = dense(torch.cat(outs, dim=-1), params[f"Dense_{len(model.denses) - 1}"])
    for idx, meta in enumerate(model.linear_bias_inputs):
        lb = params[f"LinearBias_{idx}"]["Dense_0"]["kernel"]  # [N, D, L]
        cond = inputs[meta["input_name"]].to(dtype)  # [B, D]
        out = out + torch.einsum("bd,ndl->bnl", cond, lb.to(dtype))
    out = out.permute(1, 0, 2)
    return out.to(torch.promote_types(out.dtype, torch.float32)), new_stats
