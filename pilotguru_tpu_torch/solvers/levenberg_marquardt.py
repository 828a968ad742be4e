"""Damped Gauss-Newton (Levenberg-Marquardt) for small dense problems.

Port of pilotguru_tpu/solvers/levenberg_marquardt.py. Jacobians come from
forward-mode autodiff (``torch.func.jacfwd``) unless the caller supplies a
closed-form ``residual_and_jacobian`` (the pose optimizer does: jacfwd
costs dozens of extra small launches per iteration);
``batched_levenberg_marquardt`` solves a batch of independent problems at
once from a closed-form Jacobian (fit_motion's windows). The loop always runs
``num_iters`` iterations and every decision (accept, freeze) is a
``torch.where`` on device tensors, so a solve never waits on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    x: torch.Tensor  # [D] final parameters
    loss: torch.Tensor  # [] final sum-of-squares
    iterations: torch.Tensor  # [] accepted-step count
    converged: torch.Tensor  # [] bool


def levenberg_marquardt(
    residual_fn: Callable,
    x0: torch.Tensor,
    num_iters: int = 50,
    init_damping: float = 1e-3,
    damping_down: float = 1.0 / 3.0,
    damping_up: float = 3.0,
    min_damping: float = 1e-12,
    max_damping: float = 1e12,
    grad_tol: float = 1e-10,
    diag_regularization: float = 1e-12,
    residual_and_jacobian: Optional[Callable] = None,
) -> LMResult:
    """Minimize ||residual_fn(x)||^2 with fixed-iteration-count LM.

    residual_fn: x[D] -> r[R]; padded residual slots should be zero, so they
    contribute nothing to J^T J or J^T r. Rejected steps only raise the
    damping (Nielsen gain-ratio schedule); ``converged`` reports whether the
    gradient dropped below ``grad_tol`` (updates freeze after).
    ``residual_and_jacobian``: x -> (J [R, D], r [R]), else jacfwd."""
    dim = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    eye = torch.eye(dim, dtype=dtype, device=device)

    def with_aux(x):
        r = residual_fn(x)
        return r, r

    jac_and_res = residual_and_jacobian or jacfwd(with_aux, has_aux=True)

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    x = x0
    r0 = residual_fn(x0)
    loss = (r0 * r0).sum()
    damping = scalar(init_damping)
    nu = scalar(damping_up)
    two = scalar(2.0)
    down = scalar(damping_down)
    iters = torch.zeros((), dtype=torch.int32, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    for _ in range(num_iters):
        jac, r = jac_and_res(x)  # [R, D], [R]
        jtj = jac.T @ jac
        jtr = jac.T @ r
        diag = jtj.diagonal() + diag_regularization
        a = jtj + damping * torch.diag(diag) + diag_regularization * eye
        dx = -torch.linalg.solve_ex(a, jtr)[0]

        x_try = x + dx
        r_try = residual_fn(x_try)
        loss_try = (r_try * r_try).sum()
        predicted = dx @ (damping * (diag * dx) - jtr)
        rho = (loss - loss_try) / predicted.clamp_min(1e-300)
        accept = (loss_try < loss) & (predicted > 0)

        grad_small = (2.0 * jtr).abs().max() < grad_tol
        keep = done | ~accept
        x = torch.where(keep, x, x_try)
        loss = torch.where(keep, loss, loss_try)
        shrink = torch.maximum(down, 1.0 - (2.0 * rho - 1.0) ** 3)
        damping_next = torch.where(accept, damping * shrink, damping * nu)
        nu_next = torch.where(accept, two, nu * 2.0)
        damping = torch.where(done, damping, damping_next).clamp(min_damping, max_damping)
        nu = torch.where(done, nu, nu_next)
        iters = iters + (~keep).to(torch.int32)
        done = done | grad_small
    return LMResult(x, loss, iters, done)


def batched_levenberg_marquardt(
    residual_fn: Callable,
    residual_and_jacobian: Callable,
    x0: torch.Tensor,
    num_iters: int = 50,
    init_damping: float = 1e-3,
    damping_down: float = 1.0 / 3.0,
    damping_up: float = 3.0,
    min_damping: float = 1e-12,
    max_damping: float = 1e12,
    grad_tol: float = 1e-10,
    diag_regularization: float = 1e-12,
) -> LMResult:
    """``levenberg_marquardt`` of many independent problems at once (the
    counterpart of the reference's vmapped ``batched_levenberg_marquardt``).

    x0 [..., D]: one start per problem, any leading batch shape.
    residual_fn: x [..., D] -> r [..., R]; residual_and_jacobian: x ->
    (J [..., R, D], r [..., R]). Each problem keeps its own damping, accept
    decision and freeze; the normal equations are one batched D x D solve
    an iteration, and nothing waits on the host inside the loop."""
    dtype, device = x0.dtype, x0.device
    batch = x0.shape[:-1]
    eye = torch.eye(x0.shape[-1], dtype=dtype, device=device)

    def full(v):
        return torch.full(batch, v, dtype=dtype, device=device)

    x = x0
    r0 = residual_fn(x0)
    loss = (r0 * r0).sum(-1)
    damping = full(init_damping)
    nu = full(damping_up)
    iters = torch.zeros(batch, dtype=torch.int32, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    for _ in range(num_iters):
        jac, r = residual_and_jacobian(x)  # [..., R, D], [..., R]
        jt = jac.transpose(-1, -2)
        jtj = jt @ jac
        jtr = (jt @ r[..., None])[..., 0]
        diag = jtj.diagonal(dim1=-2, dim2=-1) + diag_regularization
        a = jtj + (damping[..., None] * diag)[..., None] * eye + diag_regularization * eye
        dx = -torch.linalg.solve_ex(a, jtr)[0]

        x_try = x + dx
        r_try = residual_fn(x_try)
        loss_try = (r_try * r_try).sum(-1)
        predicted = (dx * (damping[..., None] * (diag * dx) - jtr)).sum(-1)
        rho = (loss - loss_try) / predicted.clamp_min(1e-300)
        accept = (loss_try < loss) & (predicted > 0)

        grad_small = (2.0 * jtr).abs().amax(-1) < grad_tol
        keep = done | ~accept
        x = torch.where(keep[..., None], x, x_try)
        loss = torch.where(keep, loss, loss_try)
        shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, damping_down)
        damping_next = torch.where(accept, damping * shrink, damping * nu)
        nu_next = torch.where(accept, 2.0, nu * 2.0)
        damping = torch.where(done, damping, damping_next).clamp(min_damping, max_damping)
        nu = torch.where(done, nu, nu_next)
        iters = iters + (~keep).to(torch.int32)
        done = done | grad_small
    return LMResult(x, loss, iters, done)
