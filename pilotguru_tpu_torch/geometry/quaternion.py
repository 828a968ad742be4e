"""Quaternion algebra on tensors, (w, x, y, z) layout (port of
pilotguru_tpu/geometry/quaternion.py). All functions broadcast over leading
batch dimensions."""

from __future__ import annotations

import torch


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2 for (..., 4) tensors in (w, x, y, z) layout."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), Eigen's
    ``_transformVector``: v' = v + 2 w (u x v) + 2 (u x (u x v))."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_rotation_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotation_rate_to_quat(rates, duration_sec):
    """Gyro rate (..., 3) over duration (...,) -> delta quaternion (..., 4).

    The reference's exponential map (RotationMotionToQuaternion), with its
    1e-30 singularity guard; the result is NOT normalized.

    The scalar part is cos(h) written as 1 - 2 sin^2(h / 2): the same value,
    but a gyro step's h is about 1e-3 rad, where cos lies within a few ulps
    of 1 and a library cos that is not correctly rounded there (torch's on
    the CPU misrounds about one step in ten, CUDA's more) biases every
    step's norm the same way. A chain of 10^5 steps turns that bias into
    centimetres per second of integrated speed. The subtraction from 1
    rounds once, so the scalar part is correctly rounded in float32 on any
    device, as XLA's cos gives it to the JAX package."""
    duration_sec = torch.as_tensor(duration_sec, dtype=rates.dtype, device=rates.device)
    omega = torch.linalg.vector_norm(rates, dim=-1)
    half_theta = omega * duration_sec * 0.5
    sin_norm = torch.sin(half_theta) / (omega + 1e-30)
    sin_quarter = torch.sin(half_theta * 0.5)
    cos_half = 1.0 - 2.0 * sin_quarter * sin_quarter
    return torch.cat([cos_half[..., None], rates * sin_norm[..., None]], dim=-1)


def quat_cumulative_product(dqs):
    """Running left-to-right products along the time axis (dim -2):
    out[..., t, :] = dqs[..., 0, :] * dqs[..., 1, :] * ... * dqs[..., t, :].

    The reference's ``jax.lax.associative_scan`` written out as a log-depth
    scan in tensor ops: ceil(log2 T) doubling steps, step d multiplying each
    running product by the one d places earlier (on its left). The products
    associate differently from XLA's scan and from a sequential loop, so
    results agree with either to rounding, not bit for bit."""
    out = dqs
    n = out.shape[-2]
    d = 1
    while d < n:
        out = torch.cat([out[..., :d, :], quat_multiply(out[..., :-d, :], out[..., d:, :])],
                        dim=-2)
        d *= 2
    return out


def quat_normalize(q, eps=0.0):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)
