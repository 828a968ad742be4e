"""The folded convolutions' backward in full float32: one autograd Function
whose forward is cuDNN's convolution and whose backward is a hand-written
CUDA pair (csrc/conv_bwd.cuh): dgrad, the input's gradient, and wgrad, the
weights' and the bias's.

Not a port of a TPU kernel: the JAX package leaves these gradients to XLA.
On the card the port's float32 training ran cuDNN's deterministic backward
algorithms at about an eighth of the FP32 peak, half or more of the folded
train step.

``folded_conv(x, kernel, bias, stride, groups)`` is ``F.conv2d`` of x with
the stacked per-net parameters (kernel [N, K, K, cin, cout], HWIO; bias
[N, cout]) folded group-major, as ml/folded.py folds them: ``groups`` is
N (each net reads its own channels of x) or 1 (every net reads all of x,
a trunk's first conv). Its backward returns the parameters' gradients in
their stacked layouts, and x's gradient where x needs one. It dispatches on
the tensors' device: CUDA float32 tensors launch the kernels (anything else
on the card raises); CPU tensors run the plain version,
``conv_dgrad_plain`` and ``conv_wgrad_plain``, which repeat the kernels'
decomposition in float32 op by op: dgrad adds each tap's product over the
output channels, tap by tap (the kernel adds the same products, a step of
output channels at a time); wgrad sums each of the kernels' partitions of
the pixels and adds the partitions in order (``wgrad_mapping``), the bias's
gradient as one more column of ones.

Launch counts: ``COUNTER`` counts dgrad's launches, ``BACKWARD_COUNTER``
wgrad's (its partial products and their reduction as one).

``block_conv`` is the folded path's one call for a block's conv, in train
and in eval mode; this module decides what runs (``hand_backward``): in
train mode a CUDA float32 tensor takes ``folded_conv`` and tallies
``folded.conv_bwd_hand``; anything else takes ``F.conv2d`` with the folded
kernel cast to the compute dtype, and autograd. This module also holds the
kernels' C interface (``ConvArgs``, ``SIGNATURES``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pilotguru_tpu_torch import cuda_lib
from pilotguru_tpu_torch.utils import profiling

COUNTER = cuda_lib.KernelCounter("conv_dgrad")
BACKWARD_COUNTER = cuda_lib.KernelCounter("conv_wgrad")

# The kernels' mapping (csrc/conv_bwd.cuh): at most 256 threads a block, a
# thread holding 8 values of the long side by 4 channels; a block's channel
# tile at most 64 wide; wgrad steps of 16 pixels.
_THREADS = 256
_MAX_TILE = 64
_MAX_LONG = 32  # threads along the long side
_PIXELS = 16
_MIN_STEPS = 32  # pixel steps a wgrad partition takes at the least
_SMS = 132  # the H100's streaming multiprocessors
_SM_THREADS = 512  # threads a wave holds an SM: the kernels' registers allow that many
# (kernel size, stride) pairs each kernel is built for.
DGRAD_SHAPES = ((5, 2), (3, 1), (3, 2))
WGRAD_SHAPES = ((5, 2), (3, 1), (3, 2), (8, 4))


class ConvArgs(ctypes.Structure):
    """PgConv of csrc/conv_bwd.cuh: one call's tensors and sizes."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in ("x", "dy", "w", "dx", "partial", "dw", "db")),
        *((name, ctypes.c_int) for name in ("batch", "hin", "win", "hout", "wout", "ksize",
                                            "stride", "groups", "cin", "m", "cout", "tile",
                                            "long_threads", "splits", "chunk", "rows", "cols")),
    ]


# Each source's entry points: {stem: {name: (argtypes, restype)}}; args, stream.
SIGNATURES = {"conv_bwd_f32": {
    f"pg_conv_{way}_f32": ([ctypes.POINTER(ConvArgs), ctypes.c_void_p], ctypes.c_int)
    for way in ("dgrad", "wgrad")
}}


def library(stem: str):
    """csrc/<stem>.cu's library with its entry points bound, built on the
    first call."""
    return cuda_lib.library(stem, SIGNATURES[stem])


def fold_conv_kernel(k: torch.Tensor) -> torch.Tensor:
    """[N, kh, kw, cin, cout] (stacked HWIO) -> [N * cout, cin, kh, kw]
    (OIHW, group-major)."""
    n, kh, kw, cin, cout = k.shape
    return k.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, kh, kw)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ceil4(v: int) -> int:
    return _ceil_div(v, 4) * 4


def dgrad_mapping(cin: int, m: int, hin: int, win: int, ksize: int, stride: int):
    """(channel tile, threads along the pixels, output channels a step,
    rows and columns of a block's rectangle of a phase's pixel grid) of
    dgrad for groups of ``cin`` input and ``m`` output channels over a
    ``hin`` x ``win`` input. The rectangle holds at most 8 pixels a thread;
    of the shapes that hold, the one that needs the fewest blocks over the
    largest phase, then the smallest window of dy."""
    tile = _ceil4(_ceil_div(cin, _ceil_div(cin, _MAX_TILE)))
    chunk = 16 if m % 16 == 0 else 12
    if m % chunk:
        raise ValueError(f"conv dgrad: a group's output channels ({m}) must divide into "
                         "steps of 12 or 16")
    hq, wq = _ceil_div(hin, stride), _ceil_div(win, stride)
    long_threads = min(_THREADS // (tile // 4), _MAX_LONG, _ceil_div(hq * wq, 8))
    span, taps = 8 * long_threads, _ceil_div(ksize, stride)
    rows, cols = min(((r, min(wq, span // r)) for r in range(1, min(hq, span) + 1)),
                     key=lambda rc: (_ceil_div(hq, rc[0]) * _ceil_div(wq, rc[1]),
                                     (rc[0] + taps - 1) * (rc[1] + taps - 1)))
    return tile, long_threads, chunk, rows, cols


def wgrad_mapping(pixels: int, groups: int, cin: int, m: int, ksize: int):
    """(channel tile, threads along the columns, column tiles, channel
    tiles, partitions of the pixels) of wgrad over ``pixels`` output pixels
    and ``groups`` groups of ``cin`` input and ``m`` output channels: from
    the shape alone, so the sums repeat to the bit. The blocks fill one
    wave of as many blocks an SM as 512 threads hold, and no more; a
    partition takes at least 32 steps of 16 pixels."""
    cols = ksize * ksize * cin + 1
    m_tiles = _ceil_div(m, _MAX_TILE)
    # At least 8 channels; 32 where x loads a float at a time, so that each
    # thread's loads of x sit in one column.
    tile = max(_ceil4(_ceil_div(m, m_tiles)), 8 if cin % 4 == 0 else 32)
    most = min(_THREADS // (tile // 4), _MAX_LONG)
    n_tiles = _ceil_div(cols, 8 * most)
    long_threads = _ceil_div(cols, 8 * n_tiles)
    wave = _SMS * max(1, _SM_THREADS // (tile // 4 * long_threads))  # blocks
    splits = max(1, min(wave // (n_tiles * m_tiles * groups), pixels // (_PIXELS * _MIN_STEPS)))
    return tile, long_threads, n_tiles, m_tiles, splits


def partitions(pixels: int, splits: int):
    """The [begin, end) pixel ranges of wgrad's partitions."""
    per = _ceil_div(_ceil_div(pixels, splits), _PIXELS) * _PIXELS
    return [(min(s * per, pixels), min(pixels, (s + 1) * per)) for s in range(splits)]


def _square(stride) -> int:
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if len(s) != 2 or s[0] != s[1]:
        raise ValueError(f"conv backward: want a square stride, got {stride}")
    return int(s[0])


def _window(k: int, out: int, stride: int) -> slice:
    """The input rows (or columns) that tap row (or column) k meets."""
    return slice(k, k + stride * (out - 1) + 1, stride)


def conv_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, x_shape, stride) -> torch.Tensor:
    """Plain version of dgrad: dy [B, G * m, Ho, Wo] and w [G, K, K, m, cin]
    (a group's weights with the last two axes of HWIO swapped) -> dx
    [B, G * cin, H, W] in dy's dtype, channels-last in memory. Each tap's
    product over the m channels, added tap by tap in row-major order."""
    if dy.is_cuda:
        COUNTER.count_plain_cuda_call()
    stride = _square(stride)
    b, _, h, wd = x_shape
    g, k, _, m, cin = w.shape
    ho, wo = dy.shape[2:]
    d = dy.permute(0, 2, 3, 1).reshape(b, ho, wo, g, m)
    dx = torch.zeros((b, h, wd, g, cin), dtype=dy.dtype, device=dy.device)
    for ky in range(k):
        for kx in range(k):
            part = torch.einsum("byxgm,gmc->byxgc", d, w[:, ky, kx])
            dx[:, _window(ky, ho, stride), _window(kx, wo, stride)] += part
    return dx.reshape(b, h, wd, g * cin).permute(0, 3, 1, 2)


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, groups: int, ksize: int, stride,
                     cout: int, splits: int):
    """Plain version of wgrad: x [B, G * cin, H, W] and dy [B, G * m, Ho,
    Wo] -> (dW [nets, K, K, cin, cout], db [nets, cout]), nets = G * m /
    cout. Each of ``splits`` partitions of the pixels (``partitions``) gives
    its product with im2col(x) and a column of ones; the partitions are
    added in order."""
    if dy.is_cuda:
        BACKWARD_COUNTER.count_plain_cuda_call()
    stride = _square(stride)
    b, cy, ho, wo = dy.shape
    m, cin = cy // groups, x.shape[1] // groups
    pixels = b * ho * wo
    xs = x.permute(0, 2, 3, 1)
    d = dy.permute(0, 2, 3, 1).reshape(pixels, groups, m)
    columns = [xs[:, _window(ky, ho, stride), _window(kx, wo, stride)].reshape(pixels, groups, cin)
               for ky in range(ksize) for kx in range(ksize)]
    total = None
    for k0, k1 in partitions(pixels, splits):
        part = torch.cat([torch.einsum("pgc,pgm->gcm", c[k0:k1], d[k0:k1]) for c in columns]
                         + [d[k0:k1].sum(0)[:, None]], dim=1)
        total = part if total is None else total + part
    nets_a_group = m // cout
    dw = total[:, :-1].reshape(groups, ksize, ksize, cin, nets_a_group, cout)
    dw = dw.permute(0, 4, 1, 2, 3, 5).reshape(groups * nets_a_group, ksize, ksize, cin, cout)
    return dw.contiguous(), total[:, -1].reshape(groups * nets_a_group, cout).contiguous()


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _check(name, t: torch.Tensor, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: the kernels take float32 on {device}, got {t.dtype} on "
                         f"{t.device}")
    if t.data_ptr() % 16 or t.numel() >= 2**31:
        raise ValueError(f"{name}: want a 16-byte aligned tensor of fewer than 2^31 elements, "
                         f"got {tuple(t.shape)}")


def _launch(name, counter, args, device):
    fn = getattr(library("conv_bwd_f32"), name)
    with torch.cuda.device(device):  # the launch's device owns the stream
        err = fn(ctypes.byref(args), cuda_lib.current_stream(device))
    counter.count_launch()
    cuda_lib.check_launch(name, err)


def _sizes(x_shape, dy, ksize, stride, groups):
    b, cx, h, w = x_shape
    return dict(batch=b, hin=h, win=w, hout=dy.shape[2], wout=dy.shape[3], ksize=ksize,
                stride=stride, groups=groups, cin=cx // groups, m=dy.shape[1] // groups)


def _dgrad_cuda(dy, w, x_shape, stride):
    """dx as ``conv_dgrad_plain`` gives it, through the kernel; dy
    channels-last, w contiguous."""
    groups, ksize = w.shape[0], w.shape[1]
    if (ksize, stride) not in DGRAD_SHAPES or (x_shape[1] // groups) % 4:
        raise ValueError(f"conv dgrad: no kernel for {ksize}x{ksize}/{stride} with "
                         f"{x_shape[1] // groups} input channels a group")
    for name, t in (("dy", dy), ("w", w)):
        _check(f"conv dgrad {name}", t, dy.device)
    dx = torch.empty(x_shape, dtype=dy.dtype, device=dy.device, memory_format=torch.channels_last)
    _check("conv dgrad dx", dx, dy.device)
    sizes = _sizes(x_shape, dy, ksize, stride, groups)
    tile, long_threads, chunk, rows, cols = dgrad_mapping(
        sizes["cin"], sizes["m"], sizes["hin"], sizes["win"], ksize, stride)
    args = ConvArgs(dy=dy.data_ptr(), w=w.data_ptr(), dx=dx.data_ptr(), cout=sizes["m"],
                    tile=tile, long_threads=long_threads, chunk=chunk, rows=rows, cols=cols,
                    **sizes)
    _launch("pg_conv_dgrad_f32", COUNTER, args, dy.device)
    return dx


def _wgrad_cuda(x, dy, kernel_shape, stride, groups):
    """(dW, db) as ``conv_wgrad_plain`` gives them, through the kernels; x
    and dy channels-last."""
    nets, ksize, _, cin, cout = kernel_shape
    if (ksize, stride) not in WGRAD_SHAPES or (cin % 4 and (ksize, stride) not in ((5, 2), (8, 4))):
        raise ValueError(f"conv wgrad: no kernel for {ksize}x{ksize}/{stride} with {cin} input "
                         "channels a group")
    for name, t in (("x", x), ("dy", dy)):
        _check(f"conv wgrad {name}", t, dy.device)
    sizes = _sizes(x.shape, dy, ksize, stride, groups)
    pixels = sizes["batch"] * sizes["hout"] * sizes["wout"]
    tile, long_threads, _, _, splits = wgrad_mapping(pixels, groups, cin, sizes["m"], ksize)
    partial = torch.empty((splits, groups, ksize * ksize * cin + 1, sizes["m"]),
                          dtype=torch.float32, device=dy.device)
    dw = torch.empty(kernel_shape, dtype=torch.float32, device=dy.device)
    db = torch.empty((nets, cout), dtype=torch.float32, device=dy.device)
    args = ConvArgs(x=x.data_ptr(), dy=dy.data_ptr(), partial=partial.data_ptr(),
                    dw=dw.data_ptr(), db=db.data_ptr(), cout=cout, tile=tile,
                    long_threads=long_threads, splits=splits, **sizes)
    _launch("pg_conv_wgrad_f32", BACKWARD_COUNTER, args, dy.device)
    return dw, db


def _dgrad_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The stacked HWIO kernel as dgrad reads it: [N, K, K, cout, cin]."""
    return kernel.transpose(3, 4).contiguous()


def conv_dgrad(dy, kernel, x_shape, stride, groups):
    """x's gradient of ``folded_conv`` from dy: the kernel for CUDA
    tensors, the plain version for CPU ones. Only grouped convolutions
    (``groups`` = N, the nets' own channels) have a kernel."""
    stride = _square(stride)
    if groups != kernel.shape[0]:
        raise ValueError("conv dgrad: a shared input (a trunk's first conv) takes no dgrad here")
    w = _dgrad_weights(kernel)
    if not dy.is_cuda:
        return conv_dgrad_plain(dy, w, x_shape, stride)
    return _dgrad_cuda(_channels_last(dy), w, tuple(x_shape), stride)


def conv_wgrad(x, dy, kernel_shape, stride, groups):
    """(kernel's gradient [N, K, K, cin, cout], bias's [N, cout]) of
    ``folded_conv``: the kernels for CUDA tensors, the plain version for
    CPU ones."""
    stride = _square(stride)
    if not dy.is_cuda:
        nets, ksize, _, cin, cout = kernel_shape
        b, cy, ho, wo = dy.shape
        splits = wgrad_mapping(b * ho * wo, groups, cin, cy // groups, ksize)[-1]
        return conv_wgrad_plain(x, dy, groups, ksize, stride, cout, splits)
    return _wgrad_cuda(_channels_last(x), _channels_last(dy), tuple(kernel_shape), stride, groups)


class _FoldedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, stride, groups):
        ctx.save_for_backward(x, kernel)
        ctx.stride, ctx.groups = stride, groups
        return F.conv2d(x, fold_conv_kernel(kernel), bias.reshape(-1), stride=stride,
                        groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_dgrad(dy, kernel, x.shape, ctx.stride, ctx.groups)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv_wgrad(x, dy, kernel.shape, ctx.stride, ctx.groups)
        return dx, dw, db, None, None


def folded_conv(x, kernel, bias, stride, groups: int):
    """``F.conv2d`` of x with the stacked kernel [N, K, K, cin, cout] and
    bias [N, cout] folded group-major, VALID, ``groups`` 1 or N; its
    backward through the hand-written pair (or, on the CPU, its plain
    version)."""
    return _FoldedConv.apply(x, kernel, bias, stride, groups)


def hand_backward(x: torch.Tensor, train: bool) -> bool:
    """Whether ``block_conv`` of x takes the hand-written backward: in train
    mode on a CUDA float32 tensor. bfloat16 keeps cuDNN, whose tensor cores
    an FMA design would lose to; the CPU keeps ``F.conv2d`` and autograd."""
    return train and x.is_cuda and x.dtype == torch.float32


def block_conv(x, kernel, bias, stride, groups: int, train: bool, dtype: torch.dtype):
    """A folded block's conv of x with the stacked kernel [N, K, K, cin,
    cout] and bias [N, cout], VALID, ``groups`` 1 or N: ``folded_conv``
    where ``hand_backward`` holds, else ``F.conv2d`` with the folded kernel
    and bias cast to ``dtype``."""
    if hand_backward(x, train):
        profiling.count("folded.conv_bwd_hand")
        return folded_conv(x, kernel, bias, stride, groups)
    return F.conv2d(x, fold_conv_kernel(kernel).to(dtype), bias.reshape(-1).to(dtype),
                    stride=stride, groups=groups)
