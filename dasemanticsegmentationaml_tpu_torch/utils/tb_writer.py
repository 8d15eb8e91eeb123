"""Native TensorBoard event-file writer (no tensorboard/tensorboardX).

The reference logs scalars through tensorboardX's SummaryWriter
(reference train.py:64,98,103,119-120,272-274); this image does not ship
tensorboardX, so the dashboard surface would silently vanish. This module
writes real ``events.out.tfevents.*`` files from scratch:

- TFRecord framing: uint64-LE length, masked CRC32C of the length bytes,
  payload, masked CRC32C of the payload.
- Payload: a hand-encoded ``tensorflow.Event`` protobuf
  (wall_time double#1, step int64#2, file_version string#3,
  summary message#5 -> Summary{ repeated Value#1{ tag string#1,
  simple_value float#2 } }).

Only the scalar surface is implemented because that is the only surface
the reference uses. The files open in stock TensorBoard.

Copied verbatim from ``dasemanticsegmentationaml_tpu/utils/tb_writer.py``
(framework-free), which the port may not import.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), reflected, as used by TFRecord framing.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding (only what Event/Summary need).


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    if value < 0:  # two's-complement 10-byte varint, proto2/3 semantics
        value += 1 << 64
    return _key(field, 0) + _varint(value)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    val = _bytes(1, tag.encode("utf-8")) + _float(2, float(value))
    summary = _bytes(1, val)
    return _double(1, wall_time) + _int64(2, int(step)) + _bytes(5, summary)


def encode_version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# ---------------------------------------------------------------------------


class EventWriter:
    """SummaryWriter-compatible scalar writer (add_scalar/flush/close)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        # pid suffix: two writers started within the same second on one
        # host (multi-process ranks, parallel test runs) must not append
        # into the SAME file
        fname = "events.out.tfevents.%010d.%s.%d" % (
            time.time(), socket.gethostname(), os.getpid())
        self._f = open(os.path.join(logdir, fname), "ab")
        self._f.write(frame_record(encode_version_event(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value, global_step: int = 0,
                   walltime: float = None):
        wall = time.time() if walltime is None else walltime
        self._f.write(frame_record(
            encode_scalar_event(tag, float(value), int(global_step), wall)))
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()


def default_logdir(comment: str = "") -> str:
    """tensorboardX-style runs/<Mon DD_HH-MM-SS>_<host><comment> dir."""
    stamp = time.strftime("%b%d_%H-%M-%S")
    return os.path.join(
        "runs", f"{stamp}_{socket.gethostname()}{comment}")
