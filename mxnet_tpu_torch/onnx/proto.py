"""Minimal protobuf wire-format encoder/decoder for ONNX (a copy of
``mxnet_tpu/onnx/proto.py``, which imports only the standard library).

The port needs no ``onnx`` (or ``protobuf``) package: the exporter writes
the ONNX binary format directly (ref: python/mxnet/onnx/mx2onnx serialises
via the onnx package; the wire format itself is the stable contract:
https://github.com/onnx/onnx/blob/main/onnx/onnx.proto — field numbers
below follow onnx.proto3, IR version 8 / opset 13).

Only what ONNX needs is implemented: varint + length-delimited fields,
messages as nested byte blobs, packed repeated ints for tensor dims.
"""
from __future__ import annotations

import struct

# --- wire primitives -------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def field_str(num: int, s: str) -> bytes:
    return field_bytes(num, s.encode("utf-8"))


def field_packed_varints(num: int, values) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return field_bytes(num, payload)


def field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


# --- decoder (for the importer / round-trip tests) -------------------------


def parse(buf: bytes):
    """Parse one message level → list of (field_number, wire_type, value).
    value is int for varint/fixed, bytes for length-delimited."""
    out = []
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((num, wt, v))
    return out


def _read_varint(buf: bytes, i: int):
    shift = 0
    result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def unzigzag_int64(v: int) -> int:
    """Interpret a u64 varint as int64 (protobuf int64 is 2's complement)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_packed_varints(payload: bytes):
    vals = []
    i = 0
    while i < len(payload):
        v, i = _read_varint(payload, i)
        vals.append(unzigzag_int64(v))
    return vals
