"""The share of the traced window in which nothing ran on the device, %:
one minus the union of kernel and copy intervals over every stream (the
prefetcher's included) over the window's wall time."""

LAYER = "Device"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo or vo["trace"] is None or not vo["trace"].window_s:
        return None
    return 100.0 * (1.0 - vo["trace"].busy_s / vo["trace"].window_s)
