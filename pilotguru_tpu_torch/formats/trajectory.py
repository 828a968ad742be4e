"""Trajectory JSON format: poses, plane, planar directions, turn angles
(copied from pilotguru_tpu/formats/trajectory.py; the same bytes on write).

{
  "plane": [[p00,p01,p02],[p10,p11,p12]],            # optional, 2x3
  "trajectory": [
    {"time_usec": ..., "is_lost": ..., "frame_id": ...,
     "pose": {"translation": [x,y,z],
              "rotation": {"w":..,"x":..,"y":..,"z":..}},
     "planar_direction": [dx, dy],                    # optional
     "angular_velocity": ...}                         # optional
  ]
}

On write, per-point turn angles convert to angular velocities by dividing
by the inter-frame interval (+1e-10 guard); on read they convert back by
multiplying (the reference's json_converters.cc:81-92, 127-133).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from pilotguru_tpu_torch.formats import keys
from pilotguru_tpu_torch.formats.json_io import read_json, write_json


@dataclass
class Trajectory:
    time_usec: np.ndarray  # [N] int64
    frame_id: np.ndarray  # [N] int64
    is_lost: np.ndarray  # [N] bool
    translations: np.ndarray  # [N, 3] float64
    rotations: np.ndarray  # [N, 4] float64 (w, x, y, z)
    plane: Optional[np.ndarray] = None  # [2, 3]
    planar_directions: Optional[np.ndarray] = None  # [N, 2]
    turn_angles: Optional[np.ndarray] = None  # [N]

    def __len__(self):
        return int(self.time_usec.shape[0])


def write_trajectory(
    trajectory: Trajectory, filename: str, frame_id_offset: int = 0
) -> None:
    """SetTrajectory + SetPlane (json_converters.cc:37-96, 156-170)."""
    points = []
    for i in range(len(trajectory)):
        point = {
            keys.TIME_USEC: int(trajectory.time_usec[i]),
            keys.IS_LOST: bool(trajectory.is_lost[i]),
            keys.FRAME_ID: int(trajectory.frame_id[i]) - frame_id_offset,
            keys.POSE: {
                keys.TRANSLATION: [float(v) for v in trajectory.translations[i]],
                keys.ROTATION: {
                    keys.W: float(trajectory.rotations[i][0]),
                    keys.X: float(trajectory.rotations[i][1]),
                    keys.Y: float(trajectory.rotations[i][2]),
                    keys.Z: float(trajectory.rotations[i][3]),
                },
            },
        }
        if trajectory.planar_directions is not None:
            point[keys.PLANAR_DIRECTION] = [
                float(v) for v in trajectory.planar_directions[i]
            ]
        if trajectory.turn_angles is not None:
            if i == 0:
                point[keys.ANGULAR_VELOCITY] = 0
            else:
                dt_sec = (
                    float(trajectory.time_usec[i] - trajectory.time_usec[i - 1])
                    * 1e-6
                )
                point[keys.ANGULAR_VELOCITY] = float(
                    trajectory.turn_angles[i] / (dt_sec + 1e-10)
                )
        points.append(point)

    root = {keys.TRAJECTORY: points}
    if trajectory.plane is not None:
        plane = np.asarray(trajectory.plane, np.float64)
        root[keys.PLANE] = [[float(v) for v in row] for row in plane]
    write_json(root, filename)


def read_trajectory(filename: str) -> Trajectory:
    """ParseTrajectory + ReadPlane (json_converters.cc:45-154)."""
    root = read_json(filename)
    points = root[keys.TRAJECTORY]
    n = len(points)
    times = np.zeros(n, np.int64)
    frame_ids = np.zeros(n, np.int64)
    lost = np.zeros(n, bool)
    trans = np.zeros((n, 3))
    rots = np.zeros((n, 4))
    directions = None
    turn_angles = None

    prev_time = points[0][keys.TIME_USEC] if points else 0
    for i, p in enumerate(points):
        times[i] = p[keys.TIME_USEC]
        frame_ids[i] = p[keys.FRAME_ID]
        lost[i] = p[keys.IS_LOST]
        trans[i] = p[keys.POSE][keys.TRANSLATION]
        r = p[keys.POSE][keys.ROTATION]
        rots[i] = [r[keys.W], r[keys.X], r[keys.Y], r[keys.Z]]
        if keys.PLANAR_DIRECTION in p:
            if directions is None:
                directions = np.zeros((n, 2))
            directions[i] = p[keys.PLANAR_DIRECTION]
        if keys.ANGULAR_VELOCITY in p:
            if turn_angles is None:
                turn_angles = np.zeros(n)
            dt_sec = float(times[i] - prev_time) * 1e-6
            turn_angles[i] = p[keys.ANGULAR_VELOCITY] * dt_sec
            prev_time = times[i]

    plane = None
    if keys.PLANE in root:
        plane = np.asarray(root[keys.PLANE], np.float64)
    return Trajectory(times, frame_ids, lost, trans, rots, plane, directions, turn_angles)
