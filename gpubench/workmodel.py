"""The least time the card could take for a piece of work, and the work of
the VO extractor and of a PilotNet step counted from their shapes.

Peaks are NVIDIA's published H100 SXM figures at its 700 W limit: 3.35 TB/s
of device memory, 67 TFLOP/s in float32 outside the tensor cores (a fused
multiply-add counted as two operations). A kernel's work is a file under
``kernels/``: the pattern its name matches in the trace, and its bytes and
operations as sums of coefficient times a counted quantity
(``extractor_quantities``). Each input byte is counted read once and each
output byte written once.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def bound_s(bytes_moved: float, operations: float, fused: bool = True) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the peak; without ``fused`` every multiply and add
    issues alone, at half the peak."""
    return max(bytes_moved / PEAK_BYTES_PER_S,
               operations / (PEAK_FP32_PER_S if fused else PEAK_FP32_PER_S / 2))


def level_shapes(h: int, w: int, levels: int, scale: float):
    return [(max(int(round(h / scale ** lv)), 32), max(int(round(w / scale ** lv)), 32))
            for lv in range(levels)]


def covered_pixels(h: int, w: int, yx: np.ndarray, radius: int) -> int:
    """Distinct pixels of an [h, w] image that square windows of ``radius``
    around ``yx`` [K, 2] (clamped into the image, edge-clamped windows)
    read."""
    seen = np.zeros((h, w), bool)
    offs = np.arange(-radius, radius + 1)
    for y, x in yx:
        rows = np.clip(np.clip(y, 0, h - 1) + offs, 0, h - 1)
        cols = np.clip(np.clip(x, 0, w - 1) + offs, 0, w - 1)
        seen[np.ix_(rows, cols)] = True
    return int(seen.sum())


def extractor_quantities(config: dict, level_yx=None, radius: int = 19) -> dict:
    """Per-frame quantities a kernel file's work may name: the pyramid's
    pixels, the keypoint slots, the patch values written and, given each
    level's keypoints (``level_yx``: [K_l, 2] arrays, a frame's), the
    distinct pixels the patch windows cover."""
    shapes = level_shapes(config["height"], config["width"], config["orb_levels"],
                          config["orb_scale"])
    slots = config["orb_features"]
    out = {"pyramid_pixels": sum(h * w for h, w in shapes),
           "keypoint_slots": slots,
           "patch_values": slots * (2 * radius + 1) ** 2}
    if level_yx is not None:
        out["patch_covered_pixels"] = sum(
            covered_pixels(h, w, yx, radius) for (h, w), yx in zip(shapes, level_yx))
    return out


def kernel_files() -> dict:
    """{name: its kernels/<name>.json}, every file the folder holds."""
    return {p.stem: json.loads(p.read_text()) for p in sorted(KERNELS_DIR.glob("*.json"))}


def kernel_bound_s(spec: dict, quantities: dict):
    """One launch's least time under ``spec``'s work, or None when a
    quantity it names was not counted."""
    try:
        moved = sum(c * quantities[q] for q, c in spec["bytes"].items())
        ops = sum(c * quantities[q] for q, c in spec.get("operations", {}).items())
    except KeyError:
        return None
    return bound_s(moved, ops, spec.get("fused", True))


def matches(spec: dict, name: str) -> bool:
    return re.search(spec["pattern"], name) is not None
