"""A correctly rounded fused multiply-add, round(a * b + c), built from
ordinary tensor operations, so that it gives the same bits on every device
and CPU build (``torch.addcmul`` fuses or not depending on the kernel path
it takes).

The JAX package's CPU programs, which made the repo's goldens, fuse some
multiply-adds (XLA's CPU convolution and its fused square-and-sum
reductions); the port repeats them with this function where its output
must match the goldens to the bit.

Method (Boldo and Melquiond, "Emulation of FMA and correctly rounded sums:
proved algorithms using rounding to odd", IEEE Trans. Computers 2008):
a * b = ph + pl exactly (Dekker's product), c + ph = sh + sl exactly
(Knuth's sum), and round(a * b + c) = round(sh + round_to_odd(sl + pl)).
Exact for float32 and float64 away from overflow and underflow.
"""

from __future__ import annotations

import torch

_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}  # 2^ceil(p/2) + 1
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _two_sum(x, y):
    s = x + y
    yv = s - x
    return s, (x - (s - yv)) + (y - yv)


def _split(x):
    t = _SPLIT[x.dtype] * x
    hi = t - (t - x)
    return hi, x - hi


def _two_product(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd_sum(x, y):
    """x + y rounded to the neighbour with an odd last significand bit
    when it is not exact."""
    s, e = _two_sum(x, y)
    bits = s.view(_BITS[s.dtype])
    even = (bits & 1) == 0
    step = torch.where((e > 0) == (s > 0), 1, -1).to(bits.dtype)
    return torch.where((e != 0) & even, bits + step, bits).view(s.dtype)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round(a * b + c) elementwise (broadcasting), float32 or float64."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    ph, pl = _two_product(a, b)
    sh, sl = _two_sum(c, ph)
    return sh + _round_to_odd_sum(sl, pl)
