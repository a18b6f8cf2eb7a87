"""Minimal protobuf wire-format codec (a copy of the JAX package's
``utils/protolite.py``; the port keeps its own): varint / TLV encoding and a
generic decoder that walks a message into {field_number: [values]}. The
schema, which field number means what, lives with the callers
(``data/waymo.py``).

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union


# ------------------------------------------------------------------ encoding

def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement, proto convention
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + encode_varint(value)


def field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + encode_varint(len(value)) + value


def field_string(field: int, value: str) -> bytes:
    return field_bytes(field, value.encode("utf-8"))


def field_message(field: int, encoded: bytes) -> bytes:
    return field_bytes(field, encoded)


# ------------------------------------------------------------------ decoding

def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, raw_value) over a message buffer.

    raw_value: int for varint/fixed, bytes for length-delimited.
    """
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = decode_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = decode_varint(data, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wire == 2:
            length, pos = decode_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def parse_message(data: bytes) -> Dict[int, List]:
    """Message buffer -> {field_number: [raw values in order]}."""
    out: Dict[int, List] = {}
    for field, _wire, value in iter_fields(data):
        out.setdefault(field, []).append(value)
    return out


def as_double(raw: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", raw))[0]


def as_float(raw: int) -> float:
    return struct.unpack("<f", struct.pack("<I", raw))[0]


def as_sint(raw: int) -> int:
    """Interpret a decoded varint as a signed int64."""
    return raw - (1 << 64) if raw >= (1 << 63) else raw
