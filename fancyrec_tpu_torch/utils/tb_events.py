"""Minimal TensorBoard scalar event writer, pure stdlib.

The port's own copy of fancyrec_tpu/utils/tb_events.py, unchanged.

The reference configures tensorboard_logger on every run
(reference trainer.py:21,151 -- flush_secs=5 into the run's logdir)
even though its main path never calls LogCollector.tb_log
(util/util.py:68-72). We write real scalar events for the per-epoch
metrics, so `tensorboard --logdir <run>` works against our runs without
adding a tensorflow/tensorboard dependency to the framework.

File format (what TensorBoard's event loader actually reads):
  events.out.tfevents.<unix_time>.<hostname> containing TFRecord frames
    [uint64 length][uint32 masked_crc32c(length)][payload][uint32
    masked_crc32c(payload)]
  where payload is a serialized tensorflow.Event protobuf. Only three
  Event shapes are needed -- the version header (file_version =
  "brain.Event:2"), and scalar summaries (wall_time, step,
  summary{value{tag, simple_value}}) -- so the protobuf wire encoding is
  done by hand below (varint/fixed64/length-delimited; proto field
  numbers from tensorflow/core/util/event.proto and summary.proto).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------- crc32c --

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78          # Castagnoli, reflected
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf --

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


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _scalar_event(wall_time: float, step: int, scalars: Dict[str, float]
                  ) -> bytes:
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode("utf-8"))
                     + _field_float(2, float(v)))
        for tag, v in scalars.items())
    return (_field_double(1, wall_time)            # Event.wall_time
            + _field_varint(2, max(int(step), 0))  # Event.step
            + _field_bytes(5, values))             # Event.summary


def _version_event(wall_time: float) -> bytes:
    return (_field_double(1, wall_time)
            + _field_bytes(3, b"brain.Event:2"))   # Event.file_version


# --------------------------------------------------------------- writer --

class TBEventWriter:
    """Append-only scalar event file under `logdir`.

    The file opens lazily on the first scalar batch and every record is
    flushed immediately (the reference's flush_secs=5 intent at our
    per-epoch write rate). Resolve nothing at construction time beyond
    the path, so constructing on non-primary hosts is free.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self._f = None

    def _ensure_open(self):
        if self._f is None:
            os.makedirs(self.logdir, exist_ok=True)
            self.path = os.path.join(
                self.logdir, "events.out.tfevents.%d.%s"
                % (int(time.time()), socket.gethostname()))
            self._f = open(self.path, "ab")
            self._write_record(_version_event(time.time()))
            self._f.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        numeric = {k: float(v) for k, v in scalars.items()
                   if isinstance(v, (int, float)) and v is not None}
        if not numeric:
            return
        self._ensure_open()
        self._write_record(_scalar_event(time.time(), step, numeric))
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# --------------------------------------------------------------- reader --
# (test/debug aid: parse a file this module wrote back into records)

def read_events(path: str):
    """-> list of (step, {tag: value}) scalar records; verifies CRCs."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off: off + 8]), "header crc"
        payload = data[off + 12: off + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        assert pcrc == _masked_crc(payload), "payload crc"
        off += 12 + length + 4
        rec = _parse_event(payload)
        if rec is not None:
            out.append(rec)
    return out


def _read_varint(buf: bytes, off: int):
    val, shift = 0, 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _parse_event(buf: bytes):
    step, summary = 0, None
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
            if num == 2:
                step = val
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            if num == 5:
                summary = buf[off: off + ln]
            off += ln
        else:
            raise ValueError("wire type %d" % wire)
    if summary is None:
        return None
    scalars = {}
    off = 0
    while off < len(summary):
        key, off = _read_varint(summary, off)
        ln, off = _read_varint(summary, off)
        value = summary[off: off + ln]
        off += ln
        tag, fval, voff = None, None, 0
        while voff < len(value):
            k, voff = _read_varint(value, voff)
            if k >> 3 == 1 and k & 7 == 2:
                tl, voff = _read_varint(value, voff)
                tag = value[voff: voff + tl].decode("utf-8")
                voff += tl
            elif k >> 3 == 2 and k & 7 == 5:
                (fval,) = struct.unpack_from("<f", value, voff)
                voff += 4
            else:
                raise ValueError("unexpected Value field %d" % (k >> 3))
        if tag is not None:
            scalars[tag] = fval
    return step, scalars
