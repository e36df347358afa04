"""Minimal TensorBoard event-file writer (scalar summaries, no TF needed).

The reference logs per-epoch metrics through PL's TensorBoardLogger
(reference: SubGNN/train_config.py:132-140); this writes the same
tfevents format: TFRecord framing (length + masked-crc32c) around Event
protobufs, hand-encoded (the Event/Summary wire format is tiny and stable).
A copy of subgnn_tpu/train/tb_writer.py: the same bytes for the same
scalars and clock.
"""
from __future__ import annotations

import os
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_f(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    sv = _len_delim(1, tag.encode()) + _float_f(2, float(value))
    summary = _len_delim(1, sv)  # Summary{ value=1 (repeated) }
    # Event{ wall_time=1(double), step=2(int64), summary=5 }
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3(string) }
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


class TBWriter:
    """Append scalar events to an events.out.tfevents file."""

    def __init__(self, log_dir: str | Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.getpid()}"
        self._f = open(log_dir / fname, "ab")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def add_scalars(self, metrics: dict, step: int):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
