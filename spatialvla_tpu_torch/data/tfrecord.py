"""TFRecord container format, dependency-free.

RLDS/TFDS shards are TFRecord files: each record is
    uint64 length | uint32 masked-crc32c(length) | payload |
    uint32 masked-crc32c(payload)
The C++ fast path (csrc/rlds_reader.cc) implements the same format with
threaded prefetch; this module is the pure-Python reference/fallback and
the *writer* used to build test fixtures and re-shard datasets.
"""
from __future__ import annotations

import struct
from typing import Iterator, List, Optional

import numpy as np

# crc32c (Castagnoli) table
_POLY = 0x82F63B78
_TABLE = None


def _crc_table():
    global _TABLE
    if _TABLE is None:
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
            table[i] = c
        _TABLE = table
    return _TABLE


def crc32c(data: bytes) -> int:
    # byte-at-a-time table lookup; fine for fixtures — the C++ reader is the
    # fast path for real shards
    t = _crc_table()
    crc_val = 0xFFFFFFFF
    for b in data:
        crc_val = (int(t[(crc_val ^ b) & 0xFF]) ^ (crc_val >> 8)) & 0xFFFFFFFF
    return crc_val ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def write_records(path: str, records: List[bytes]):
    with open(path, "wb") as f:
        for payload in records:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str, *, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if verify_crc:
                if masked_crc32c(header) != hcrc:
                    raise IOError(f"{path}: header crc mismatch")
                if masked_crc32c(payload) != pcrc:
                    raise IOError(f"{path}: payload crc mismatch")
            yield payload


def count_records(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return n
            (length,) = struct.unpack("<Q", header)
            f.seek(4 + length + 4, 1)  # header crc + payload + payload crc
            n += 1
