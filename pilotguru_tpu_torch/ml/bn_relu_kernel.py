"""Batch norm in train mode fused with the ReLU after it: the folded
PilotNet's train-mode normalisation (ml/folded.py) as one autograd Function.

Not a port of a TPU kernel: the JAX package writes this expression in jnp
and XLA fuses it. Written op by op in PyTorch it broadcasts [C] statistics
over the activation in 8 passes forward and 14 backward; the hand-written
kernels (csrc/bn_relu.cuh) make two passes each way.

``bn_relu_train(x, scale, bias, mean_ra, var_ra, eps, momentum)`` -> (y,
new running mean, new running var), differentiable in x, scale and bias,
dispatches on x's device: a CUDA tensor launches the kernels (float32 or
bfloat16, else it raises); a CPU tensor runs the plain version,
``bn_relu_train_plain`` and ``bn_relu_backward_plain``, which repeat the
kernels' arithmetic: statistics summed in float64, every other operation in
float32 (the wider of x's dtype and float32), rounded op by op as PyTorch's
separate ops round. x is [B, C] or [B, C, H, W]; the statistics are over
every axis but C, as ``bn_train_ops`` takes them, with the
ReLU applied after the cast to x's dtype. The kernels read a [B, C, H, W]
activation in its channels-last order, the order cuDNN leaves the folded
convolutions' outputs in, so y and dx of a [B, C, H, W] x are channels-last.

``block_bn_relu`` is the folded path's one call for a block's batch norm
and ReLU, in train and in eval mode; this module decides what runs
(``takes_kernels``): in train mode a CUDA tensor takes the Function and
tallies ``folded.bn_fused``; a CPU tensor in train mode takes
``bn_train_ops`` and eval mode ``bn_eval_ops``, PyTorch ops written as the
JAX package's folded path writes them. This module also holds the kernels'
C interface (``BnArgs``, ``SIGNATURES``).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from pilotguru_tpu_torch import cuda_lib
from pilotguru_tpu_torch.utils import profiling

COUNTER = cuda_lib.KernelCounter("bn_relu_forward")
BACKWARD_COUNTER = cuda_lib.KernelCounter("bn_relu_backward")

# The library (csrc/bn_relu_<suffix>.cu) and entry points of each dtype.
_SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernels' mapping (csrc/bn_relu.cuh): 256 threads a block, a thread
# owning 4 consecutive channels where C allows, a block's tile at most 64
# such vectors wide.
_THREADS = 256
_MAX_WIDTH = 64
_STATS_BLOCKS = 1024  # about one wave of 8 blocks on 132 SMs


class BnArgs(ctypes.Structure):
    """PgBn of csrc/bn_relu.cuh: one call's tensors and sizes."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("x", "g", "out", "scale", "bias", "mean_ra",
                                               "var_ra", "stats", "grads", "partial")),
        ("rows", ctypes.c_longlong),
        *((name, ctypes.c_int) for name in ("channels", "vec", "tiles", "parts", "groups")),
        *((name, ctypes.c_float) for name in ("eps", "momentum", "one_minus_momentum")),
    ]


# Each source's entry points: {stem: {name: (argtypes, restype)}}; args, stream.
SIGNATURES = {
    f"bn_relu_{suffix}": {f"pg_bn_relu_{way}_{suffix}": (
        [ctypes.POINTER(BnArgs), ctypes.c_void_p], ctypes.c_int) for way in ("forward", "backward")}
    for suffix in _SUFFIXES.values()
}


def library(stem: str):
    """csrc/<stem>.cu's library with its entry points bound, built on the
    first call."""
    return cuda_lib.library(stem, SIGNATURES[stem])


def kernel_mapping(rows: int, channels: int):
    """(vector width, channel tiles, partitions of the rows, groups of
    partitions) of the statistics passes over a [rows, channels]
    activation: from the shape alone, so the sums repeat to the bit. About
    one wave of blocks, each thread summing at least 8 rows; about
    sqrt(partitions) groups, so each level of the sums' reduction adds about
    as many terms."""
    vec = 4 if channels % 4 == 0 else 1
    vectors = channels // vec
    tiles = -(-vectors // _MAX_WIDTH)
    rows_per_step = _THREADS // -(-vectors // tiles)
    parts = max(1, min(-(-_STATS_BLOCKS // tiles), rows // (8 * rows_per_step)))
    return vec, tiles, parts, math.isqrt(parts - 1) + 1


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as [n, C]: a [B, C] as it is, a [B, C, H, W] in its channels-last
    order (a view where t is channels-last, else a copy)."""
    if t.dim() == 2:
        return t
    if t.dim() == 4:
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])
    raise ValueError(f"bn_relu: want [B, C] or [B, C, H, W], got {tuple(t.shape)}")


def _unrows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_rows``: [n, C] in ``like``'s shape, channels-last
    for a [B, C, H, W]."""
    if like.dim() == 2:
        return rows
    b, c, h, w = like.shape
    return rows.reshape(b, h, w, c).permute(0, 3, 1, 2)


def bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, eps: float, momentum: float):
    """Plain PyTorch version of the forward kernels: (y in x's dtype, stats
    [5, C]: mean, rstd, keep (1 where the raw variance is not below 0, else
    0), new running mean, new running var)."""
    if x.is_cuda:
        COUNTER.count_plain_cuda_call()
    wide = torch.promote_types(x.dtype, torch.float32)
    xw = _rows(x).to(wide)
    xd = xw.double()
    n = xw.shape[0]
    mean64 = xd.sum(0) / n
    var64 = (xd * xd).sum(0) / n - mean64 * mean64
    mean = mean64.to(wide)
    var = var64.clamp(min=0.0).to(wide)
    keep = (var64 >= 0).to(wide)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    new_mean = momentum * mean_ra + (1.0 - momentum) * mean
    new_var = momentum * var_ra + (1.0 - momentum) * var
    y = torch.relu(((xw - mean) * rstd * scale + bias).to(x.dtype))
    return _unrows(y, x), torch.stack([mean, rstd, keep, new_mean, new_var])


def bn_relu_backward_plain(g, x, scale, bias, stats):
    """Plain PyTorch version of the backward kernels, from the upstream
    gradient g (x's shape and dtype) and the forward's stats: (dx in x's
    dtype, grads [4, C]: dscale, dbias, dbias / n, and dscale / n where
    keep is set, else 0)."""
    if x.is_cuda:
        BACKWARD_COUNTER.count_plain_cuda_call()
    wide = torch.promote_types(x.dtype, torch.float32)
    mean, rstd, keep = stats[0], stats[1], stats[2]
    xhat = (_rows(x).to(wide) - mean) * rstd
    n = xhat.shape[0]
    pre = (xhat * scale + bias).to(x.dtype)
    gp = torch.where(pre <= 0, 0.0, _rows(g)).to(wide)  # threshold_backward's rule
    gd = gp.double()
    sg = gd.sum(0)
    sgx = (gd * xhat.double()).sum(0)
    mean_g = (sg / n).to(wide)
    mean_gx = torch.where(keep != 0, (sgx / n).to(wide), 0.0)
    dx = rstd * scale * ((gp - mean_g) - xhat * mean_gx)
    return _unrows(dx.to(x.dtype), x), torch.stack([sgx.to(wide), sg.to(wide), mean_g, mean_gx])


def _format(t: torch.Tensor):
    return torch.channels_last if t.dim() == 4 else torch.contiguous_format


def _kernel_ready(t: torch.Tensor) -> bool:
    """t is laid out as the kernels read it: a contiguous [B, C] or a
    channels-last [B, C, H, W], 16-byte aligned."""
    return (t.dim() in (2, 4) and t.is_contiguous(memory_format=_format(t))
            and t.data_ptr() % 16 == 0)


def _for_kernel(t: torch.Tensor) -> torch.Tensor:
    """t laid out as the kernels read it (a copy only where it is not)."""
    if t.dim() not in (2, 4):
        raise ValueError(f"bn_relu: want [B, C] or [B, C, H, W], got {tuple(t.shape)}")
    return t if _kernel_ready(t) else t.clone(memory_format=_format(t))


def _check(name, x, params):
    if x.dtype not in _SUFFIXES:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16, got {x.dtype}")
    if not _kernel_ready(x):
        raise ValueError(f"{name}: want a contiguous [B, C] or a channels-last [B, C, H, W], "
                         f"16-byte aligned; got {tuple(x.shape)} with strides {x.stride()}")
    for p in params:
        if p.device != x.device or p.dtype != torch.float32 or p.dim() != 1 \
                or p.shape[0] != x.shape[1] or not p.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous float32 [{x.shape[1]}] parameters and statistics "
                f"on {x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")


def _launch(name, counter, x, scale, bias, stats, **fields):
    """One call of a C entry point over x ([n, C] in memory) with its
    scratch: the statistics pass's partial sums, its groups' sums, then
    tiles * (groups + 1) int tickets."""
    c = x.shape[1]
    rows = x.numel() // c
    vec, tiles, parts, groups = kernel_mapping(rows, c)
    tickets = tiles * (groups + 1)
    scratch = torch.empty(2 * (parts + groups) * c + (tickets + 1) // 2, dtype=torch.float64,
                          device=x.device)
    args = BnArgs(
        x=x.data_ptr(), scale=scale.data_ptr(), bias=bias.data_ptr(), stats=stats.data_ptr(),
        partial=scratch.data_ptr(), rows=rows, channels=c, vec=vec, tiles=tiles, parts=parts,
        groups=groups, **fields)
    suffix = _SUFFIXES[x.dtype]
    name = f"{name}_{suffix}"
    fn = getattr(library(f"bn_relu_{suffix}"), name)
    with torch.cuda.device(x.device):  # the launch's device owns the stream
        err = fn(ctypes.byref(args), cuda_lib.current_stream(x.device))
    counter.count_launch()
    cuda_lib.check_launch(name, err)


def _forward_cuda(x, scale, bias, mean_ra, var_ra, eps, momentum):
    """(y, stats) as ``bn_relu_train_plain`` gives them, through the kernels;
    x as ``_for_kernel`` gives it."""
    _check("bn_relu_forward", x, (scale, bias, mean_ra, var_ra))
    y = torch.empty_like(x)
    stats = torch.empty((5, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch("pg_bn_relu_forward", COUNTER, x, scale, bias, stats, out=y.data_ptr(),
            mean_ra=mean_ra.data_ptr(), var_ra=var_ra.data_ptr(), eps=eps, momentum=momentum,
            one_minus_momentum=1.0 - momentum)
    return y, stats


def _backward_cuda(g, x, scale, bias, stats):
    """(dx, grads) as ``bn_relu_backward_plain`` gives them, through the
    kernels; g and x as ``_for_kernel`` gives them."""
    _check("bn_relu_backward", x, (scale, bias))
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device \
            or not _kernel_ready(g):
        raise ValueError(f"bn_relu_backward: want the gradient laid out as x, {x.dtype} "
                         f"{tuple(x.shape)}, got {g.dtype} {tuple(g.shape)} {g.stride()}")
    dx = torch.empty_like(x)
    grads = torch.empty((4, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch("pg_bn_relu_backward", BACKWARD_COUNTER, x, scale, bias, stats, g=g.data_ptr(),
            out=dx.data_ptr(), grads=grads.data_ptr())
    return dx, grads


class _BnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, mean_ra, var_ra, eps, momentum):
        if x.is_cuda:
            x = _for_kernel(x)
            y, stats = _forward_cuda(x, scale, bias, mean_ra, var_ra, eps, momentum)
        else:
            y, stats = bn_relu_train_plain(x, scale, bias, mean_ra, var_ra, eps, momentum)
        ctx.save_for_backward(x, scale, bias, stats)
        new_mean, new_var = stats[3], stats[4]
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, gy, _new_mean, _new_var):
        x, scale, bias, stats = ctx.saved_tensors
        if x.is_cuda:
            dx, grads = _backward_cuda(_for_kernel(gy), x, scale, bias, stats)
        else:
            dx, grads = bn_relu_backward_plain(gy, x, scale, bias, stats)
        return dx, grads[0], grads[1], None, None, None, None


def bn_relu_train(x, scale, bias, mean_ra, var_ra, eps: float, momentum: float):
    """relu(batch norm of x in train mode, cast to x's dtype), and the
    running statistics updated with ``momentum``: (y, new_mean, new_var).
    scale, bias, mean_ra and var_ra are [C] float32 (x's dtype or wider on
    the CPU)."""
    return _BnRelu.apply(x, scale, bias, mean_ra, var_ra, eps, momentum)


def _wide(x):
    """x in float32, or wider: flax's batch norm computes in at least
    float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _broadcast(x):
    """(the axes the statistics reduce over, the [C] shape that broadcasts
    over x) of a [B, C] or [B, C, H, W] x."""
    return ((0, 2, 3), (1, -1, 1, 1)) if x.dim() == 4 else ((0,), (1, -1))


def bn_train_ops(x, scale, bias, mean_ra, var_ra, eps: float, momentum: float):
    """Batch norm of x in train mode in float32 as PyTorch ops, as the JAX
    package's folded path writes it: the biased batch variance normalises
    and updates. Returns (y, new_mean_ra, new_var_ra)."""
    axes, shape = _broadcast(x)
    xf = _wide(x)
    mean = xf.mean(axes)
    var = torch.clamp(torch.mean(xf * xf, axes) - mean * mean, min=0.0)
    y = ((xf - mean.view(shape)) * torch.rsqrt(var + eps).view(shape) * scale.view(shape)
         + bias.view(shape))
    new_mean = momentum * mean_ra + (1.0 - momentum) * mean.detach()
    new_var = momentum * var_ra + (1.0 - momentum) * var.detach()
    return y, new_mean, new_var


def bn_eval_ops(x, scale, bias, mean_ra, var_ra, eps: float):
    """Batch norm of x in eval mode in float32 as PyTorch ops."""
    _, shape = _broadcast(x)
    return ((_wide(x) - mean_ra.view(shape)) * torch.rsqrt(var_ra + eps).view(shape)
            * scale.view(shape) + bias.view(shape))


def takes_kernels(x: torch.Tensor, train: bool) -> bool:
    """Whether ``block_bn_relu`` of x runs the fused kernels: in train mode
    on a CUDA tensor."""
    return train and x.is_cuda


def block_bn_relu(x, scale, bias, mean_ra, var_ra, eps: float, momentum: float, train: bool,
                  dtype: torch.dtype):
    """relu(batch norm of x in float32, cast to ``dtype``) for a folded
    block, and the running statistics: (y, new_mean, new_var), updated with
    ``momentum`` in train mode, ``mean_ra`` and ``var_ra`` as given in eval
    mode. x is [B, C] or [B, C, H, W]; the [C] parameters and statistics
    are float32."""
    if not train:
        return F.relu(bn_eval_ops(x, scale, bias, mean_ra, var_ra, eps).to(dtype)), mean_ra, var_ra
    if takes_kernels(x, train):
        profiling.count("folded.bn_fused")
        return bn_relu_train(x, scale, bias, mean_ra, var_ra, eps, momentum)
    y, new_mean, new_var = bn_train_ops(x, scale, bias, mean_ra, var_ra, eps, momentum)
    return F.relu(y.to(dtype)), new_mean, new_var
