"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py),
with the names it exports but ``CorpusBuckets``: the JAX package's shape
buckets for XLA's compiled programs, which the port does not pad to (see
calib/corpus.py)."""

from pilotguru_tpu_torch.calib.accelerometer import (  # noqa: F401
    NUM_PARAMS,
    integrate_window,
    replay_windows,
    solve_windows,
    window_loss,
    window_residuals,
)
from pilotguru_tpu_torch.calib.corpus import (  # noqa: F401
    RideArrays,
    fit_motion_corpus,
)
from pilotguru_tpu_torch.calib.fit_motion import (  # noqa: F401
    FitMotionConfig,
    FitMotionResult,
    fit_motion_arrays,
    window_loss_fn,
)
from pilotguru_tpu_torch.calib.integrate import (  # noqa: F401
    integrate_motion_debiased,
)
from pilotguru_tpu_torch.calib.interpolate import (  # noqa: F401
    InterpolationSettings,
    interpolate_gps_velocities,
)
from pilotguru_tpu_torch.calib.pieces import (  # noqa: F401
    RidePieces,
    WindowedProblem,
    build_ride_pieces,
    build_windowed_problem,
)
from pilotguru_tpu_torch.calib.rotation_axis import (  # noqa: F401
    angular_velocities_around_axis,
    integrate_rotation_chunks,
    principal_rotation_axes,
    rotations_complementary_to_axis,
)
