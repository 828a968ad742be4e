"""Quaternion algebra on tensors, (w, x, y, z) layout (port of the parts of
pilotguru_tpu/geometry/quaternion.py that trajectory flattening uses).
All functions broadcast over leading batch dimensions."""

from __future__ import annotations

import torch


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), Eigen's
    ``_transformVector``: v' = v + 2 w (u x v) + 2 (u x (u x v))."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))
