"""Host file formats the port reads and writes (its own copies).
It re-exports the names of the matching pilotguru_tpu package."""

from pilotguru_tpu_torch.formats import keys  # noqa: F401
from pilotguru_tpu_torch.formats.json_io import (  # noqa: F401
    dumps,
    read_forward_axis,
    read_frames,
    read_gps_velocities,
    read_json,
    read_timestamped_3d,
    read_timestamped_values,
    write_forward_axis,
    write_json,
    write_timestamped_values,
)
