"""First-party TensorBoard scalar event writer (no TF dependency).

The reference logs through HF Trainer's ``--report_to tensorboard``
(torchrun_pretrain.sh:70); this writes the same on-disk artifact — an
``events.out.tfevents.*`` file TensorBoard/XProf reads natively — from ~100
lines: TB event files are TFRecord streams (length/crc framing, shared with
data/tfrecord.py) of hand-encodable ``Event`` protos carrying
``Summary.Value{tag, simple_value}`` messages.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Union

from ..data.tfrecord import masked_crc32c

# --------------------------------------------------------------------------
# minimal protobuf wire encoding (only what Event/Summary scalars need)
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint((field << 3) | 0) + _varint(value)


def _field_double(field: int, value: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", value)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_scalar_event(
    wall_time: float, step: int, scalars: Dict[str, float]
) -> bytes:
    """Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}."""
    summary = b"".join(
        _field_bytes(
            1,
            _field_bytes(1, tag.encode("utf-8")) + _field_float(2, float(v)),
        )
        for tag, v in scalars.items()
    )
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def encode_file_version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 — TB requires "brain.Event:2" as the first record
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _frame(payload: bytes) -> bytes:
    """TFRecord framing: u64 length + masked crc32c(length) + payload +
    masked crc32c(payload) (data/tfrecord.py:4-5)."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------


class SummaryWriter:
    """Append-only scalar event writer, TB-compatible.

    ``SummaryWriter(logdir).add_scalars(step, {"loss": 1.2})`` produces an
    ``events.out.tfevents.<ts>.<host>`` file under ``logdir`` that
    ``tensorboard --logdir`` picks up directly.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_frame(encode_file_version_event(now)))
        self._f.flush()

    def add_scalar(self, tag: str, value: Union[float, int], step: int):
        self.add_scalars(step, {tag: float(value)})

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        self._f.write(_frame(encode_scalar_event(time.time(), step, scalars)))

    def flush(self):
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None
