"""tf.train.Example / SequenceExample wire-format codec, dependency-free.

RLDS episodes are serialized tf.Example protos inside TFRecord shards. This
module parses/serializes the exact wire format (proto3 varint/length-
delimited encoding) without TensorFlow or protobuf installed:

    Example        { Features features = 1; }
    Features       { map<string, Feature> feature = 1; }
    Feature        { BytesList bytes_list = 1 | FloatList float_list = 2 |
                     Int64List int64_list = 3 }
    BytesList      { repeated bytes value = 1; }
    FloatList      { repeated float value = 1 [packed]; }
    Int64List      { repeated int64 value = 1 [packed]; }

The C++ reader (csrc/rlds_reader.cc) implements the same parser natively.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

Value = Union[List[bytes], List[float], List[int]]


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def _parse_bytes_list(buf: memoryview) -> List[bytes]:
    out, pos, n = [], 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1 and (tag & 7) == 2:
            ln, pos = _read_varint(buf, pos)
            out.append(bytes(buf[pos : pos + ln]))
            pos += ln
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return out


def _parse_float_list(buf: memoryview) -> List[float]:
    out, pos, n = [], 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1:
            if (tag & 7) == 2:  # packed
                ln, pos = _read_varint(buf, pos)
                out.extend(struct.unpack(f"<{ln // 4}f", bytes(buf[pos : pos + ln])))
                pos += ln
            elif (tag & 7) == 5:  # unpacked fixed32
                out.append(struct.unpack("<f", bytes(buf[pos : pos + 4]))[0])
                pos += 4
            else:
                pos = _skip_field(buf, pos, tag & 7)
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return out


def _zigzag_free_int64(v: int) -> int:
    # int64 fields are two's-complement varints (not zigzag)
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_int64_list(buf: memoryview) -> List[int]:
    out, pos, n = [], 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 == 1:
            if (tag & 7) == 2:  # packed
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    out.append(_zigzag_free_int64(v))
            elif (tag & 7) == 0:
                v, pos = _read_varint(buf, pos)
                out.append(_zigzag_free_int64(v))
            else:
                pos = _skip_field(buf, pos, tag & 7)
        else:
            pos = _skip_field(buf, pos, tag & 7)
    return out


def _parse_feature(buf: memoryview) -> Value:
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt != 2:
            pos = _skip_field(buf, pos, wt)
            continue
        ln, pos = _read_varint(buf, pos)
        sub = buf[pos : pos + ln]
        pos += ln
        if field == 1:
            return _parse_bytes_list(sub)
        if field == 2:
            return _parse_float_list(sub)
        if field == 3:
            return _parse_int64_list(sub)
    return []


def parse_example(payload: bytes) -> Dict[str, Value]:
    """Serialized tf.train.Example -> {feature_name: list of values}."""
    buf = memoryview(payload)
    features: Dict[str, Value] = {}
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        if tag >> 3 != 1 or (tag & 7) != 2:
            pos = _skip_field(buf, pos, tag & 7)
            continue
        ln, pos = _read_varint(buf, pos)
        fbuf = buf[pos : pos + ln]
        pos += ln
        # Features: repeated map entries (field 1)
        fpos, fn = 0, len(fbuf)
        while fpos < fn:
            ftag, fpos = _read_varint(fbuf, fpos)
            if ftag >> 3 != 1 or (ftag & 7) != 2:
                fpos = _skip_field(fbuf, fpos, ftag & 7)
                continue
            eln, fpos = _read_varint(fbuf, fpos)
            entry = fbuf[fpos : fpos + eln]
            fpos += eln
            # MapEntry: key=1 (string), value=2 (Feature)
            key, val = None, []
            epos, en = 0, len(entry)
            while epos < en:
                etag, epos = _read_varint(entry, epos)
                if etag >> 3 == 1 and (etag & 7) == 2:
                    kln, epos = _read_varint(entry, epos)
                    key = bytes(entry[epos : epos + kln]).decode("utf-8")
                    epos += kln
                elif etag >> 3 == 2 and (etag & 7) == 2:
                    vln, epos = _read_varint(entry, epos)
                    val = _parse_feature(entry[epos : epos + vln])
                    epos += vln
                else:
                    epos = _skip_field(entry, epos, etag & 7)
            if key is not None:
                features[key] = val
    return features


# ---------------------------------------------------------------------------
# serialization (for fixtures / re-sharding)
# ---------------------------------------------------------------------------

def _ld(out: bytearray, field: int, payload: bytes):
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(value: Value) -> bytes:
    inner = bytearray()
    if len(value) and isinstance(value[0], (bytes, str)):
        lst = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _ld(lst, 1, v)
        _ld(inner, 1, bytes(lst))
    elif len(value) and isinstance(value[0], (int,)):
        packed = bytearray()
        for v in value:
            _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
        lst = bytearray()
        _ld(lst, 1, bytes(packed))
        _ld(inner, 3, bytes(lst))
    else:  # floats (or empty -> float list)
        packed = struct.pack(f"<{len(value)}f", *value)
        lst = bytearray()
        _ld(lst, 1, packed)
        _ld(inner, 2, bytes(lst))
    return bytes(inner)


def serialize_example(features: Dict[str, Value]) -> bytes:
    fbuf = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _ld(entry, 1, key.encode("utf-8"))
        _ld(entry, 2, _encode_feature(value))
        _ld(fbuf, 1, bytes(entry))
    out = bytearray()
    _ld(out, 1, bytes(fbuf))
    return bytes(out)
