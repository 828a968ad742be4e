"""Kernels launched on the device a frame, every stream (the prefetcher's
extraction included), over the traced window: kernel events over the
frames the segment loop consumed."""

LAYER = "Device"
SOURCE = "device_trace"
UNIT = "launches/frame"
BETTER = "lower"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo or vo["trace"] is None or not vo["consumed"]:
        return None
    return vo["trace"].kernels / vo["consumed"]
