"""The port's SVD entry, and its linear solve where the card's float32
solve was measured less exact than LAPACK's.

Every SVD of the port (two-view geometry, Sim(3) fits, relocalization's
DLT) goes through ``svd``, so where the work runs decides how it is
computed, in one place:

- a CPU tensor: ``torch.linalg.svd`` as it is, which is LAPACK's, the
  routine the JAX package runs on the CPU;
- a CUDA float32 tensor: one batched float64 SVD on the card, its factors
  rounded to float32. cuSOLVER's float32 Jacobi routes, which
  ``torch.linalg.svd`` takes on the card, land several times further from
  the exact factors than LAPACK's float32 does (PERF.md). The float64
  upcast is exact and the rounding costs half a float32 ulp. (On the card
  the two-view initialization computes in float64 as a whole,
  vo/twoview.py, so this route serves the Sim(3) fits and relocalization);
- any other CUDA tensor: ``torch.linalg.svd`` as it is.

``solve_ex`` does the same for ``torch.linalg.solve_ex``; local bundle
adjustment's reduced camera system goes through it (on the card in
float32, cuSOLVER's LU solve landed five times further from the exact
solution than LAPACK's float32 does; PERF.md). That exactness is its
whole case: on the rides measured it moves no tracking decision. The pose
and calibration LMs keep ``torch.linalg.solve_ex``: there the card's
float32 solve is as exact as LAPACK's.

A failure on the card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def svd(a: torch.Tensor, full_matrices: bool = True):
    """(U, S, Vh) of ``a`` [..., m, n], as ``torch.linalg.svd``."""
    if a.device.type != "cuda" or a.dtype != torch.float32:
        return torch.linalg.svd(a, full_matrices=full_matrices)
    u, s, vh = torch.linalg.svd(a.to(torch.float64), full_matrices=full_matrices)
    return u.to(torch.float32), s.to(torch.float32), vh.to(torch.float32)


def solve_ex(a: torch.Tensor, b: torch.Tensor):
    """(X, info) of ``a`` X = ``b``, as ``torch.linalg.solve_ex``."""
    if a.device.type != "cuda" or a.dtype != torch.float32:
        return torch.linalg.solve_ex(a, b)
    x, info = torch.linalg.solve_ex(a.to(torch.float64), b.to(torch.float64))
    return x.to(torch.float32), info
