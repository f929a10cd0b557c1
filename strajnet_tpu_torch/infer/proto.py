"""Minimal binary-protobuf writer (wire format only, no proto runtime).

The waymo_open_dataset package is not available in this environment, so the
challenge submission protos are emitted with a tiny hand-rolled encoder.
Only the pieces the submission needs: varints, length-delimited fields
(strings / bytes / sub-messages) and bools.
"""

from __future__ import annotations

from typing import Union


def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def encode_bytes_field(field_number: int,
                       value: Union[bytes, str]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _key(field_number, 2) + encode_varint(len(value)) + value


def encode_message_field(field_number: int, message: bytes) -> bytes:
    return _key(field_number, 2) + encode_varint(len(message)) + message


def encode_varint_field(field_number: int, value: int) -> bytes:
    return _key(field_number, 0) + encode_varint(value)


def encode_bool_field(field_number: int, value: bool) -> bytes:
    return encode_varint_field(field_number, 1 if value else 0)


# ---- decoding helpers (round-trip tests / inspection) ----

def decode_varint(buf: bytes, pos: int = 0):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) triples from a message."""
    pos = 0
    while pos < len(buf):
        key, pos = decode_varint(buf, pos)
        field_number, wire_type = key >> 3, key & 0x7
        if wire_type == 0:
            value, pos = decode_varint(buf, pos)
        elif wire_type == 2:
            length, pos = decode_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire_type == 5:
            value = buf[pos:pos + 4]
            pos += 4
        elif wire_type == 1:
            value = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value
