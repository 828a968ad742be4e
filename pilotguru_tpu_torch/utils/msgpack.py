"""A MessagePack codec for the subset that flax.serialization's
msgpack_serialize writes, so the port reads and writes the JAX package's
checkpoints without the msgpack or flax packages.

Values: maps (str keys, written in sorted order, as flax's tree_map leaves
them), arrays (lists, tuples), str, bin (bytes), int, float (float64), bool
and None; numpy arrays as ext type 1, ``(shape, dtype name, C-order
bytes)`` packed as an array; numpy scalars as ext type 3, packed the same
way with shape (). Each value takes the shortest encoding, as msgpack's
packer does, so the bytes equal flax's for the same tree. Ext type 2 (a
Python complex) and flax's chunked arrays (over 2^30 bytes each) raise
ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NATIVE_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit 64 bits")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_limit: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form (``codes``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} over 2^32")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not serialised")
    return packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code) + data


def _pack(value: Any, out: bytearray) -> None:
    if value is None:
        out.append(0xC0)
    elif value is True:
        out.append(0xC3)
    elif value is False:
        out.append(0xC2)
    elif isinstance(value, np.ndarray):
        if value.size * value.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError("msgpack: arrays over 2^30 bytes (flax's chunked form) "
                             "are not written")
        _pack_ext(EXT_NDARRAY, _ndarray_payload(value), out)
    elif isinstance(value, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(value)), out)
    elif isinstance(value, int):
        _pack_int(value, out)
    elif isinstance(value, float):
        out += b"\xcb" + struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(value, (bytes, bytearray)):
        _pack_len(len(value), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += value
    elif isinstance(value, (list, tuple)):
        _pack_len(len(value), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in value:
            _pack(item, out)
    elif isinstance(value, dict):
        _pack_len(len(value), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key in sorted(value):
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            _pack(key, out)
            _pack(value[key], out)
    elif isinstance(value, complex):
        raise ValueError("msgpack: Python complex values (ext type 2) are not written")
    else:
        raise ValueError(f"msgpack: cannot serialise {type(value).__name__}")


def packb(value: Any) -> bytes:
    out = bytearray()
    _pack(value, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not read (numpy has no bfloat16)")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _unpack_ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    if code == EXT_NATIVE_COMPLEX:
        raise ValueError("msgpack: ext type 2 (a Python complex) is not read")
    raise ValueError(f"msgpack: unknown ext type {code}")


def _read(r: _Reader, raw: bool):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
    if b in lengths:
        return r.take(r.unpack(lengths[b]))
    exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    if b in exts:
        n = r.unpack(exts[b])
        code = r.unpack(">b")
        return _unpack_ext(code, r.take(n))
    fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixed_ext:
        code = r.unpack(">b")
        return _unpack_ext(code, r.take(fixed_ext[b]))
    numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in numbers:
        return r.unpack(numbers[b])
    strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in strs:
        return _str(r.take(r.unpack(strs[b])), raw)
    if b in (0xDC, 0xDD):
        return [_read(r, raw) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")


def _str(data: bytes, raw: bool):
    return data if raw else data.decode("utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, raw)
        out[key] = _read(r, raw)
    if CHUNKED_KEY in out:
        raise ValueError("msgpack: flax's chunked arrays (over 2^30 bytes) are not read")
    return out


def unpackb(data: bytes, raw: bool = False):
    """Decode one value; ``raw``: strings stay bytes."""
    reader = _Reader(bytes(data))
    value = _read(reader, raw)
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value")
    return value
