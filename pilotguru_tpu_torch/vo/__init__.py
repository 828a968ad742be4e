"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py),
with the names it exports."""

from pilotguru_tpu_torch.vo.camera import (  # noqa: F401
    CameraSettings,
    read_camera_settings,
    write_camera_settings,
)
from pilotguru_tpu_torch.vo.flatten import (  # noqa: F401
    flatten_trajectory,
    plane_is_valid,
    project_directions,
    project_translations,
    trajectory_pca,
    turn_angles_from_directions,
)
from pilotguru_tpu_torch.vo.tracking import (  # noqa: F401
    LOST,
    NOT_INITIALIZED,
    OK,
    CameraModel,
    MonocularTracker,
    TrackerConfig,
)
