"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py),
with the names it exports."""

from pilotguru_tpu_torch.solvers.gradient_descent import gradient_descent  # noqa: F401
from pilotguru_tpu_torch.solvers.levenberg_marquardt import (  # noqa: F401
    LMResult,
    batched_levenberg_marquardt,
    levenberg_marquardt,
)
