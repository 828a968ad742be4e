"""JSON file reading and writing in the reference's layout (copied from
pilotguru_tpu/formats/json_io.py): nlohmann::json ``dump(2)`` sorts object
keys and ends the file with a newline, so ``json.dumps(indent=2,
sort_keys=True)`` plus a newline writes the same bytes."""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

from pilotguru_tpu_torch.formats import keys


def read_json(filename: str) -> dict:
    with open(filename, "r") as f:
        return json.load(f)


def dumps(data: dict) -> str:
    return json.dumps(data, indent=2, sort_keys=True, allow_nan=True)


def write_json(data: dict, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(dumps(data))
        f.write("\n")


def read_timestamped_3d(filename: str, root_element: str):
    """Read {root: [{x, y, z, time_usec}, ...]} into (times_usec int64 [N],
    values float64 [N, 3] with columns x, y, z)."""
    entries = read_json(filename)[root_element]
    if not entries:
        raise ValueError(f"empty '{root_element}' list in {filename}")
    times = np.asarray([e[keys.TIME_USEC] for e in entries], dtype=np.int64)
    values = np.asarray([[e[keys.X], e[keys.Y], e[keys.Z]] for e in entries], dtype=np.float64)
    return times, values


def read_gps_velocities(filename: str):
    """Read locations.json into (times_usec int64 [N], speeds_m_s float64
    [N]); only ``speed_m_s`` and ``time_usec`` are read."""
    locations = read_json(filename)[keys.LOCATIONS]
    if not locations:
        raise ValueError(f"empty '{keys.LOCATIONS}' list in {filename}")
    times = np.asarray([e[keys.TIME_USEC] for e in locations], dtype=np.int64)
    speeds = np.asarray([e[keys.SPEED_M_S] for e in locations], dtype=np.float64)
    return times, speeds


def read_timestamped_values(filename: str, root_element: str, value_name: str):
    """Read a scalar series {root: [{time_usec, <value_name>}, ...]} into
    (times_usec int64 [N], values float64 [N]) (the reference's
    RealTimeSeries JSON ingestion)."""
    entries = read_json(filename)[root_element]
    times = np.asarray([e[keys.TIME_USEC] for e in entries], dtype=np.int64)
    values = np.asarray([e[value_name] for e in entries], dtype=np.float64)
    return times, values


def write_timestamped_values(times_usec: Sequence[int], values: Sequence[float],
                             filename: str, root_element: str, value_name: str) -> None:
    """Write {root: [{time_usec, <value_name>}, ...]}."""
    times_usec = np.asarray(times_usec)
    values = np.asarray(values)
    if times_usec.shape[0] != values.shape[0]:
        raise ValueError("times and values length mismatch")
    events = [{keys.TIME_USEC: int(t), value_name: float(v)}
              for t, v in zip(times_usec, values)]
    write_json({root_element: events}, filename)


def read_frames(filename: str):
    """Read the recorder's frames.json ({frames: [{frame_id, time_usec}]})
    into (frame_ids int64 [F], times_usec int64 [F])."""
    frames = read_json(filename)[keys.FRAMES]
    ids = np.asarray([e[keys.FRAME_ID] for e in frames], dtype=np.int64)
    times = np.asarray([e[keys.TIME_USEC] for e in frames], dtype=np.int64)
    return ids, times


def write_forward_axis(axis, filename: str) -> None:
    """Write {"forward_axis": {x, y, z}}."""
    axis = np.asarray(axis, dtype=np.float64)
    write_json({keys.FORWARD_AXIS: {keys.X: float(axis[0]), keys.Y: float(axis[1]),
                                    keys.Z: float(axis[2])}}, filename)


def read_forward_axis(filename: str) -> np.ndarray:
    """Read {"forward_axis": {x, y, z}} into a float64 [3] array."""
    ax = read_json(filename)[keys.FORWARD_AXIS]
    return np.asarray([ax[keys.X], ax[keys.Y], ax[keys.Z]], dtype=np.float64)
