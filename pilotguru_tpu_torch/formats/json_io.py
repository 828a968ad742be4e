"""JSON file reading and writing in the reference's layout (copied from
pilotguru_tpu/formats/json_io.py): nlohmann::json ``dump(2)`` sorts object
keys and ends the file with a newline, so ``json.dumps(indent=2,
sort_keys=True)`` plus a newline writes the same bytes."""

from __future__ import annotations

import json


def read_json(filename: str) -> dict:
    with open(filename, "r") as f:
        return json.load(f)


def write_json(data: dict, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(json.dumps(data, indent=2, sort_keys=True, allow_nan=True))
        f.write("\n")
