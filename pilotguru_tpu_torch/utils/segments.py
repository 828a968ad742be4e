"""Deterministic row accumulation, the port's segment sums.

``out[index[i]] += values[i]`` in an order fixed by the data, so a run
repeats to the bit: on CUDA ``index_put_(accumulate=True)`` sorts the
indices and sums each segment in that order (``index_add_`` would add with
atomics, in whatever order the threads arrive); on the CPU
``index_put_(accumulate=True)`` adds from several threads with atomics
once the input is large, while ``index_add_`` adds row by row in index
order there.
"""

from __future__ import annotations

import torch


def accumulate_rows(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Add ``values`` [N, ...] into the rows ``index`` [N] of ``out`` in place
    and return ``out``."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, values)
    return out.index_put_((index,), values, accumulate=True)
