"""Many-ride fit_motion (port of pilotguru_tpu/calib/corpus.py).

The reference calibrates a corpus one fit_motion process per ride. The
JAX package runs every ride through one compiled program and pads each
ride's shapes up to buckets so that XLA compiles once per bucket; PyTorch
compiles nothing, so the port has no buckets: each ride goes through
fit_motion's own pieces (``principal_rotation_axes``,
``build_window_index``, ``_solve_and_reduce``, ``assemble_result``) at its
own shapes, one ride after another, on ``FitMotionConfig.device``. A
ride's result is therefore the same, bit for bit, as its
``fit_motion_arrays`` result on the same device and dtype.

With a ``mesh`` (parallel/mesh.py, the ``("windows",)`` mesh of
preprocess_corpus --shard_windows), each ride's windows are solved and
replayed in contiguous blocks, one a device, and gathered back in window
order before the cross-window sums, which the JAX package leaves to XLA's
collectives; the sums therefore keep the unsharded order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from pilotguru_tpu_torch.calib.fit_motion import (
    FitMotionConfig,
    FitMotionResult,
    fit_motion_arrays,
)
from pilotguru_tpu_torch.parallel.mesh import Mesh
from pilotguru_tpu_torch.utils.profiling import StageTimer


class RideArrays(NamedTuple):
    """One ride's raw sensor streams (the inputs of fit_motion_arrays)."""

    rot_times_usec: np.ndarray  # [R] int64
    rot_rates: np.ndarray  # [R, 3]
    acc_times_usec: np.ndarray  # [A] int64
    accelerations: np.ndarray  # [A, 3]
    gps_times_usec: np.ndarray  # [G] int64
    gps_speeds: np.ndarray  # [G]


def fit_motion_corpus(
    rides: Sequence[RideArrays],
    config: FitMotionConfig = FitMotionConfig(),
    timer=None,
    mesh: Optional[Mesh] = None,
) -> list[FitMotionResult]:
    """Calibrate every ride of a corpus; one FitMotionResult per ride, in
    order. ``timer`` (a StageTimer) accumulates fit_motion's stages over
    all rides; ``mesh`` spreads each ride's windows over its devices."""
    timer = timer or StageTimer("fit_motion_corpus")
    return [fit_motion_arrays(*ride, config=config, timer=timer, mesh=mesh) for ride in rides]
