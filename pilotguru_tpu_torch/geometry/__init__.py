"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py),
with the names it exports."""

from pilotguru_tpu_torch.geometry.quaternion import (  # noqa: F401
    quat_conjugate,
    quat_cumulative_product,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_rotation_matrix,
    rotation_rate_to_quat,
)
from pilotguru_tpu_torch.geometry.strapdown import (  # noqa: F401
    StrapdownResult,
    integrate_motion,
)
