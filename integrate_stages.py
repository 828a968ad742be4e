"""integrate_motion's float32 stage by stage (PERF.md §6).

    python3 integrate_stages.py [--devices cpu cuda] [--fit-motion]

On chip_smoke's 300 s ride with hills and sensor noise (seed 101), the
port's integrate_motion_debiased is run one stage at a time in float32 on
each device and in float64 on the CPU: the delta quaternions
(rotation_rate_to_quat), the orientation scan (quat_cumulative_product),
the rotated accelerations, the velocity increments, their cumulative sum
(strapdown's blocked order, and beside it torch.cumsum's), and the
debiased speeds. Each stage is computed from the float32 run's own
previous stage, and printed as its largest difference from the float64
run's, together with the same stage computed from the float64 run's
previous stage rounded to float32 (what the stage alone adds).

--fit-motion: fit_motion_arrays on the same ride in float32 on each device,
against float64 on the CPU (largest difference of the speeds and of the
forward axis), with the two float32 choices of the strapdown integration
swapped one at a time: the delta quaternions' scalar part as the library's
cos(h) instead of 1 - 2 sin^2(h / 2), and blocked_cumsum instead of
torch.cumsum for the windows' velocities.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke
from pilotguru_tpu_torch.geometry.quaternion import (
    quat_cumulative_product,
    quat_rotate,
    rotation_rate_to_quat,
)
from pilotguru_tpu_torch.geometry.strapdown import integrate_motion as strapdown_integrate
from pilotguru_tpu_torch.timeseries.interval_average import blocked_cumsum
from pilotguru_tpu_torch.timeseries.merge import merge_time_series


def stages(rates, accs, dts, elapsed, total_sec, device, dtype, given=None):
    """The stages' outputs (float64 numpy); ``given``: each stage's input
    taken from these outputs (rounded to ``dtype``) instead of the run's
    own previous stage."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def feed(name, own):
        return put(given[name]) if given is not None else own

    out = {}
    r, a, d = put(rates), put(accs), put(dts)
    dq = rotation_rate_to_quat(r, d)
    out["delta_quaternions"] = dq
    q = quat_cumulative_product(feed("delta_quaternions", dq))
    out["orientations"] = q
    q = feed("orientations", q)
    q_pre = torch.cat([q.new_tensor([[1.0, 0.0, 0.0, 0.0]]), q[:-1]])
    a_global = quat_rotate(q_pre, a)
    out["rotated_accelerations"] = a_global
    dv = feed("rotated_accelerations", a_global) * d[:, None]
    out["velocity_increments"] = dv
    out["velocities (torch.cumsum)"] = torch.cumsum(feed("velocity_increments", dv), dim=0)
    v = blocked_cumsum(feed("velocity_increments", dv))
    out["velocities"] = v
    v = feed("velocities", v)
    bias = v[-1] / put(total_sec)
    out["speeds"] = torch.linalg.vector_norm(v - bias[None, :] * put(elapsed)[:, None], dim=-1)
    return {k: t.detach().cpu().double().numpy() for k, t in out.items()}


def _library_cos_rate_to_quat(rates, duration_sec):
    duration_sec = torch.as_tensor(duration_sec, dtype=rates.dtype, device=rates.device)
    omega = torch.linalg.vector_norm(rates, dim=-1)
    half_theta = omega * duration_sec * 0.5
    sin_norm = torch.sin(half_theta) / (omega + 1e-30)
    return torch.cat([torch.cos(half_theta)[..., None], rates * sin_norm[..., None]], dim=-1)




def _blocked_integrate(*args, **kwargs):
    return strapdown_integrate(*args, **kwargs, cumsum=blocked_cumsum)


def fit_motion_variants(arrays, devices) -> None:
    import contextlib
    import importlib
    import pkgutil

    import pilotguru_tpu_torch
    from pilotguru_tpu_torch.calib.fit_motion import FitMotionConfig, fit_motion_arrays

    modules = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        pilotguru_tpu_torch.__path__, "pilotguru_tpu_torch.")
        if m.name.split(".")[1] in ("calib", "geometry")]

    @contextlib.contextmanager
    def swapped(name, fn):
        saved = [(m, getattr(m, name)) for m in modules if hasattr(m, name)]
        for m, _ in saved:
            setattr(m, name, fn)
        try:
            yield
        finally:
            for m, old in saved:
                setattr(m, name, old)

    def run(device, dtype):
        return fit_motion_arrays(*arrays[:6], FitMotionConfig(dtype=dtype, device=device))

    reference = run("cpu", torch.float64)
    variants = {"as it stands": contextlib.nullcontext,
                "library cos": lambda: swapped("rotation_rate_to_quat",
                                               _library_cos_rate_to_quat),
                "blocked_cumsum": lambda: swapped("integrate_motion", _blocked_integrate)}
    for device in devices:
        for name, context in variants.items():
            with context():
                got = run(device, torch.float32)
            row = {"speeds": float(np.abs(got.velocities_m_s - reference.velocities_m_s).max()),
                   "forward_axis": float(np.abs(got.forward_axis
                                                - reference.forward_axis).max())}
            print(f"fit_motion float32 on {device}, {name}, against cpu float64: "
                  f"{json.dumps(row)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--devices", nargs="+", default=["cpu"])
    parser.add_argument("--fit-motion", action="store_true")
    args = parser.parse_args()
    arrays, _ = chip_smoke.make_imu_ride(300.0, climb_m_s=1.5, seed=101)
    if args.fit_motion:
        fit_motion_variants(arrays, args.devices)
        return 0
    rot_t, rates, acc_t, accs = arrays[:4]
    times, idx = merge_time_series([rot_t, acc_t])
    inputs = (np.asarray(rates, np.float64)[idx[1:, 0]], np.asarray(accs, np.float64)[idx[1:, 1]],
              np.diff(times).astype(np.float64) * 1e-6, (times[1:] - times[0]) * 1e-6,
              (times[-1] - times[0]) * 1e-6)
    reference = stages(*inputs, "cpu", torch.float64)
    for device in args.devices:
        own = stages(*inputs, device, torch.float32)
        alone = stages(*inputs, device, torch.float32, given=reference)
        row = {name: {"chained": float(np.abs(own[name] - ref).max()),
                      "alone": float(np.abs(alone[name] - ref).max())}
               for name, ref in reference.items()}
        print(f"integrate_motion float32 on {device} against cpu float64: {json.dumps(row)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
