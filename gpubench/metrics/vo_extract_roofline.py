"""The feature extractor's hand kernels against their roofline, %: the
least time of every launch of a kernel listed under kernels/ (its work at
the frame's shapes and the checked frames' keypoints, workmodel.py) over
the device time those launches took, over the traced window."""

from gpubench import workmodel

LAYER = "Kernels"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "vo_frames_per_s"


def read(layer: dict):
    vo = layer.get("vo")
    if not vo or vo["trace"] is None:
        return None
    least = spent = 0.0
    for spec in workmodel.kernel_files().values():
        bound = workmodel.kernel_bound_s(spec, vo["quantities"])
        for name, (launches, seconds) in vo["trace"].by_name.items():
            if workmodel.matches(spec, name) and bound is not None:
                least += launches * bound
                spent += seconds
    if not spent:
        return None
    return 100.0 * least / spent
