"""The parallax ride: its frames, its true poses, and a written trajectory
held against them.

A frozen copy of the parallax ride the repository's smoke test renders and
holds to its true poses (filled squares on 2,400 billboards seen from a
planar path that sways sideways and yaws while it moves forward), with the
billboards' layout and shades drawn from a seed (the smoke's is 7), drawn
on a torch device in a few large calls per frame instead of one numpy
slice per billboard. Plain torch and numpy only: this module imports
nothing of the program under test.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

BACKGROUND = 25  # the grey behind the billboards


def ride_pose(t: int, traffic: dict):
    """True pose of ride frame ``t``: (camera centre in the world [3],
    world-to-camera rotation [3, 3]); the camera looks down +z, y down."""
    phase = 2 * math.pi * t / traffic["period_frames"]
    centre = np.array([traffic["sway"] * math.sin(phase), 0.0, traffic["forward_speed"] * t])
    yaw = traffic["yaw"] * math.cos(phase)
    c, s = math.cos(yaw), math.sin(yaw)
    return centre, np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def billboards(traffic: dict, seed: int):
    """(points [P, 3] float64, shades [P] int64) of the ride, drawn from
    ``seed``: uniform in the box ``traffic["box"]``."""
    (x0, x1), (y0, y1), (z0, z1) = traffic["box"]
    count = traffic["billboards"]
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(x0, x1, count), rng.uniform(y0, y1, count),
                    rng.uniform(z0, z1, count)], axis=1)
    lo, hi = traffic["shade"]
    return pts, rng.integers(lo, hi, count)


def render_frame(pts, shade, centre, rot, width: int, height: int, fx: float,
                 dot_scale: float) -> torch.Tensor:
    """One uint8 [height, width] frame: each billboard a filled square of
    side 2r + 1, r = max(round(dot_scale * fx / depth), 1), centred at its
    projection (principal point at the image centre); where squares overlap
    the nearest shows (ties: the lower billboard index)."""
    device = pts.device
    cx, cy = width / 2.0, height / 2.0
    local = (pts - torch.as_tensor(centre, device=device)) @ torch.as_tensor(rot.T,
                                                                              device=device)
    z = local[:, 2]
    zs = torch.where(z >= 0.5, z, torch.ones_like(z))
    u = fx * local[:, 0] / zs + cx
    v = fx * local[:, 1] / zs + cy
    r = torch.clamp(torch.round(dot_scale * fx / zs), min=1).to(torch.int64)
    keep = (z >= 0.5) & (u >= -r) & (u < width + r) & (v >= -r) & (v < height + r)
    idx = torch.nonzero(keep)[:, 0]
    # Rank by depth, nearest first (a stable sort: ties by index).
    order = idx[torch.sort(z[idx], stable=True).indices]
    r, side = r[order], 2 * r[order] + 1
    u0 = torch.trunc(u[order]).to(torch.int64) - r
    v0 = torch.trunc(v[order]).to(torch.int64) - r
    counts = side * side
    owner = torch.repeat_interleave(torch.arange(order.numel(), device=device), counts)
    start = torch.cumsum(counts, 0) - counts
    j = torch.arange(owner.numel(), device=device) - start[owner]
    rows = v0[owner] + j // side[owner]
    cols = u0[owner] + j % side[owner]
    inside = (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
    flat = rows[inside] * width + cols[inside]
    nearest = torch.full((height * width,), order.numel(), dtype=torch.int64, device=device)
    nearest.scatter_reduce_(0, flat, owner[inside], reduce="amin")
    table = torch.cat([shade[order], torch.tensor([BACKGROUND], device=device)])
    return table[nearest].to(torch.uint8).view(height, width)


def render_ride(traffic: dict, config: dict, device, seed: int) -> np.ndarray:
    """Every frame of the ride whose billboards ``seed`` draws, uint8
    [frames, height, width] on the host."""
    pts, shade = (torch.as_tensor(a, device=device) for a in billboards(traffic, seed))
    frames = torch.empty((traffic["frames"], config["height"], config["width"]),
                         dtype=torch.uint8, device=device)
    for t in range(traffic["frames"]):
        centre, rot = ride_pose(t, traffic)
        frames[t] = render_frame(pts, shade, centre, rot, config["width"], config["height"],
                                 config["fx"], traffic["dot_scale"])
    return frames.cpu().numpy()


def read_trajectory(path: str) -> dict:
    """A trajectory JSON as written by the VO CLI: frame ids, camera centres,
    camera-to-world quaternions (w, x, y, z) and the fitted plane."""
    with open(path) as f:
        root = json.load(f)
    points = root["trajectory"]
    rot = [p["pose"]["rotation"] for p in points]
    return {
        "frame_id": np.array([p["frame_id"] for p in points], np.int64),
        "is_lost": np.array([p["is_lost"] for p in points], bool),
        "translations": np.array([p["pose"]["translation"] for p in points], np.float64),
        "rotations": np.array([[q["w"], q["x"], q["y"], q["z"]] for q in rot], np.float64),
        "plane": np.array(root["plane"], np.float64) if "plane" in root else None,
    }


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def sim3_aligned(src, dst):
    """Camera centres ``src`` [N, 3] aligned to ``dst`` by Sim(3)
    (Umeyama): (aligned centres, the rotation, their RMSE to ``dst``,
    ``dst``'s path length)."""
    src = np.asarray(src, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    u, d, vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    sign = np.diag([1.0, 1.0, np.sign(np.linalg.det(u) * np.linalg.det(vt))])
    r = u @ sign @ vt
    c = np.trace(np.diag(d) @ sign) / (((src - mu_s) ** 2).sum() / len(src))
    aligned = (c * (r @ (src - mu_s).T)).T + mu_d
    rmse = np.sqrt(((aligned - dst) ** 2).sum(1).mean())
    return aligned, r, rmse, np.linalg.norm(np.diff(dst, axis=0), axis=1).sum()


def trajectory_errors(traj: dict, traffic: dict) -> dict:
    """A written trajectory against the ride's true poses.

    The tracker's world is its first keyframe's camera at its own scale, so
    rotations compare relative to the segment's first frame and camera
    centres after a Sim(3) alignment; the fitted plane's normal compares,
    rotated by that alignment, with the ground plane's normal (world y).
    Frame ids past the ride's end name the ride again from its start."""
    frames = traffic["frames"]
    ids = traj["frame_id"] % frames
    true_c = np.stack([ride_pose(int(i), traffic)[0] for i in ids])
    true_c2w = np.stack([ride_pose(int(i), traffic)[1].T for i in ids])
    est_c2w = np.stack([_quat_to_matrix(q) for q in traj["rotations"]])
    rot_err = []
    for r_est, r_true in zip(est_c2w, true_c2w):
        d = (est_c2w[0].T @ r_est).T @ (true_c2w[0].T @ r_true)
        rot_err.append(math.degrees(math.acos(min(max((np.trace(d) - 1) / 2, -1.0), 1.0))))
    _, r, rmse, length = sim3_aligned(traj["translations"], true_c)
    normal = r @ np.cross(traj["plane"][0], traj["plane"][1])
    cos = abs(normal[1]) / np.linalg.norm(normal)
    return {
        "rotation_max_deg": float(max(rot_err)),
        "rotation_mean_deg": float(np.mean(rot_err)),
        "centre_rmse_of_path": float(rmse / length),
        "normal_deg": float(math.degrees(math.acos(min(cos, 1.0)))),
    }
