"""Minimal TensorBoard event writer — standard library only (the port's copy
of the JAX package's ``engine/summary.py``).

Scalar logging in the TFRecord/Event wire format: each record is

    [len: uint64 LE][masked crc32c(len)][payload][masked crc32c(payload)]

where payload is a hand-encoded ``tensorflow.Event`` protobuf
(wall_time=1 double, step=2 int64, file_version=3 string,
summary=5 { value=1 { tag=1 string, simple_value=2 float } }).
Readable by TensorBoard and ``tf.data.TFRecordDataset`` alike.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# --- crc32c (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- tiny protobuf encoder ----------------------------------------------------

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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack('<f', v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
    msg = _f_double(1, wall_time)
    if step is not None:
        msg += _f_varint(2, step)
    if file_version is not None:
        msg += _f_bytes(3, file_version.encode())
    if tag is not None:
        sv = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
        msg += _f_bytes(5, _f_bytes(1, sv))
    return msg


class SummaryWriter:
    """Scalar event writer with periodic flush (FileWriter parity)."""

    def __init__(self, logdir: str, flush_secs: float = 5.0):
        os.makedirs(logdir, exist_ok=True)
        # pid in the name: two same-host writers in the same second (e.g. a
        # local multi-process run) must not append-interleave one TFRecord
        # stream — TensorBoard drops everything after the first torn record
        fname = 'events.out.tfevents.{:d}.{}.{:d}'.format(
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, 'ab')
        self._flush_secs = flush_secs
        self._last_flush = time.time()
        self._write(_event(time.time(), file_version='brain.Event:2'))

    def _write(self, payload: bytes):
        header = struct.pack('<Q', len(payload))
        self._f.write(header)
        self._f.write(struct.pack('<I', masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack('<I', masked_crc32c(payload)))
        if time.time() - self._last_flush > self._flush_secs:
            self.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_event(time.time(), step=step, tag=tag, value=float(value)))

    def flush(self):
        self._f.flush()
        self._last_flush = time.time()

    def close(self):
        self.flush()
        self._f.close()
