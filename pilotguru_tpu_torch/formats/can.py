"""Kia Cee'd CAN frame decoding for recorder logs (copied from
pilotguru_tpu/formats/can.py: the reference's hex parsing in
src/car/can.cc:63-124 and frame decoding in src/car/kia_can.cc:11-73).
Host-only; it serves process_can_frames."""

from __future__ import annotations

from typing import Optional, Tuple

STEERING_WHEEL_ANGLE_CAN_ID = 0x2B0
STEERING_WHEEL_ANGLE_FRAME_PAYLOAD_SIZE = 5
STEERING_WHEEL_ANGLE_INVALID_VALUE = 32767
VELOCITY_CAN_ID = 0x4B0
VELOCITY_FRAME_PAYLOAD_SIZE = 8
CAN_MAX_DLEN = 8


def try_parse_can_frame(text: str) -> Optional[Tuple[int, bytes]]:
    """Parse "ID HH HH ..." hex text into (can_id, payload).

    Matches try_parse_can_frame (can.cc:63-124): the id is hex up to the
    first space; each payload byte is exactly two hex characters separated
    by single spaces; a trailing separator is tolerated; anything else
    (double spaces, odd-length bytes, >8 bytes) fails.
    """
    sep_idx = text.find(" ")
    id_str = text if sep_idx < 0 else text[:sep_idx]
    try:
        can_id = int(id_str, 16)
    except ValueError:
        return None

    payload = bytearray()
    pos = len(id_str)
    while pos < len(text):
        if text[pos] != " ":
            return None
        start = pos + 1
        end = start + 2
        if start >= len(text):
            break  # trailing separator
        if end >= len(text) and end != len(text):
            return None
        if end > len(text):
            return None
        if len(payload) >= CAN_MAX_DLEN:
            return None
        chunk = text[start:end]
        if len(chunk) != 2:
            return None
        try:
            payload.append(int(chunk, 16))
        except ValueError:
            return None
        pos = end
    return can_id, bytes(payload)


def parse_can_int16(data: bytes) -> int:
    """Little-endian signed 16-bit (kia_can.cc:11-25)."""
    value = data[0] | (data[1] << 8)
    return value - 0x10000 if value >= 0x8000 else value


def integer_average_int16(values) -> int:
    """Overflow-safe integer mean with C truncation semantics.

    Intent of kia_can.cc:27-36: accumulate truncated per-element quotients
    plus the truncated mean of the remainders, avoiding summing full int16
    values. NOTE: the reference accumulates ``v - v/n`` where the remainder
    is evidently meant to be ``v % n`` (``v - n*(v/n)``) — as written it
    returns ~1.75x the true mean for n=4 (e.g. four equal speeds of 10000
    -> 17500), a constant distortion users absorb into
    --velocity_scale_can_units_to_m_s. This implementation computes the
    correct truncated mean.
    """
    n = len(values)

    def trunc_div(a, b):
        q = abs(a) // b
        return q if a >= 0 else -q

    result = 0
    remainder = 0
    for v in values:
        frac = trunc_div(v, n)
        result += frac
        remainder += v - n * frac
    return result + trunc_div(remainder, n)


def parse_steering_angle_degrees(payload: bytes) -> Optional[float]:
    """0x2B0 frame -> steering wheel angle in degrees (deci-degree int16,
    kia_can.hpp:35-41). Returns None on wrong payload size."""
    if len(payload) != STEERING_WHEEL_ANGLE_FRAME_PAYLOAD_SIZE:
        return None
    return parse_can_int16(payload[0:2]) / 10.0


def parse_wheel_speeds(payload: bytes):
    """0x4B0 frame -> (fl, fr, rl, rr) wheel speeds in CAN units."""
    if len(payload) != VELOCITY_FRAME_PAYLOAD_SIZE:
        return None
    return tuple(parse_can_int16(payload[i : i + 2]) for i in (0, 2, 4, 6))


def parse_average_wheel_speed(payload: bytes) -> Optional[int]:
    speeds = parse_wheel_speeds(payload)
    if speeds is None:
        return None
    return integer_average_int16(speeds)
