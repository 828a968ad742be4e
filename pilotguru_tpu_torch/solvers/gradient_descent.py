"""First-order descent with learning-rate decay and elementwise gradient
clipping (port of pilotguru_tpu/solvers/gradient_descent.py; the
reference's GradientDescent, src/optimization/gradient_descent.cc:18-33):
each iteration clips every gradient component into [min_clip, max_clip],
takes a step and decays the learning rate.

The caller gives the gradient as a function (the port's objectives write
theirs in closed form). Every iteration runs on the parameters' device and
nothing waits on the host inside the loop. The step x - lr * g is one fused
multiply-add, as XLA compiles the JAX package's scan on the CPU, so a step
repeats the reference's bits.
"""

from __future__ import annotations

from typing import Callable

import torch

from pilotguru_tpu_torch.utils.fma import fma


def gradient_descent(
    grad_fn: Callable,
    x0: torch.Tensor,
    num_iters: int,
    learning_rate: float,
    learning_rate_decay: float = 1.0,
    min_gradient_clip: float = -10.0,
    max_gradient_clip: float = 10.0,
) -> torch.Tensor:
    """The parameters after ``num_iters`` steps from ``x0`` (a tensor; the
    learning rate is carried in its dtype, as the reference's scan does)."""
    x = x0
    lr = torch.full((), learning_rate, dtype=x0.dtype, device=x0.device)
    for _ in range(int(num_iters)):
        g = grad_fn(x).clamp(min_gradient_clip, max_gradient_clip)
        x = fma(-lr, g, x)
        lr = lr * learning_rate_decay
    return x
