"""Minimal TensorBoard event-file writer — no TensorFlow dependency (the
port's own copy of `avsync/utils/tb.py`).

The reference logs training scalars through Keras' TensorBoard callback
(`train.py:745-748`; event files checked into its `logs/`). TensorFlow is
not part of this framework, so this module writes the TFRecord/Event wire
format directly: ~100 lines of protobuf varint encoding + masked CRC32C.
Files load in stock TensorBoard (`tensorboard --logdir ...`).

Format per record: <uint64 len><uint32 masked_crc(len)><data>
<uint32 masked_crc(data)>; `data` is a serialized `tensorflow.Event` proto
(field 1 wall_time double, 2 step int64, 3 file_version string,
5 summary message; Summary.Value: 1 tag string, 2 simple_value float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import List

# --- CRC32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire encoding -------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, tag: str, value: float, wall: float) -> bytes:
    val = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, val)
    return _double(1, wall) + _int64(2, step) + _bytes(5, summary)


def _record(event: bytes) -> bytes:
    header = struct.pack("<Q", len(event))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + event
        + struct.pack("<I", _masked_crc(event))
    )


class SummaryWriter:
    """TensorBoard scalar writer: SummaryWriter(dir).add_scalar(tag, v, step)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        # version header event
        self._f.write(
            _record(_double(1, time.time()) + _bytes(3, b"brain.Event:2"))
        )
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_record(_scalar_event(step, tag, value, time.time())))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str) -> List[dict]:
    """Parse a scalar-only event file back (used by tests; also a sanity
    check that the CRC framing is well-formed)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        hdr = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(hdr), "header CRC mismatch"
        ev = data[pos + 12 : pos + 12 + ln]
        (ecrc,) = struct.unpack_from("<I", data, pos + 12 + ln)
        assert ecrc == _masked_crc(ev), "event CRC mismatch"
        pos += 12 + ln + 4
        out.append(_parse_event(ev))
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _parse_event(buf: bytes) -> dict:
    ev: dict = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            if field == 1:
                ev["wall_time"] = v
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            if field == 2:
                ev["step"] = v
        elif wire == 5:
            (v,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if field == 3:
                ev["file_version"] = sub.decode()
            elif field == 5:
                ev.update(_parse_summary(sub))
    return ev


def _parse_summary(buf: bytes) -> dict:
    out: dict = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        if key >> 3 == 1 and key & 7 == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
            vpos = 0
            while vpos < len(val):
                vkey, vpos = _read_varint(val, vpos)
                if vkey >> 3 == 1 and vkey & 7 == 2:
                    vln, vpos = _read_varint(val, vpos)
                    out["tag"] = val[vpos : vpos + vln].decode()
                    vpos += vln
                elif vkey >> 3 == 2 and vkey & 7 == 5:
                    (out["value"],) = struct.unpack_from("<f", val, vpos)
                    vpos += 4
    return out
