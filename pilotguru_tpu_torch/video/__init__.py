"""Frame input of the port: image lists and video readers (its own copies),
PNG on zlib and cv2-equal image processing, none of which needs cv2.
It re-exports the names of the matching pilotguru_tpu package."""

from pilotguru_tpu_torch.video.io import VideoWriterRgb, read_video_rgb  # noqa: F401
from pilotguru_tpu_torch.video.render import (  # noqa: F401
    MotionRenderer,
    load_per_frame_series,
    render_frame_number,
    render_steering,
    render_velocity,
)
