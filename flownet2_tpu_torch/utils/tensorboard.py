"""TensorBoard-compatible event writer, dependency-free: the port's copy
of flownet2_tpu/utils/tensorboard.py (numpy and the stdlib only).

The reference logs TensorboardX scalars for every loss label and a
histogram per model parameter.  This module writes the same records
without the tensorboard/tensorboardX dependency by encoding the two
protobufs involved (``Event`` and ``Summary``/``HistogramProto``) and the
TFRecord framing (length + masked crc32c) directly.

Files written as ``events.out.tfevents.<time>.<host>`` are readable by any
stock TensorBoard ``--logdir``; ``read_events`` reads them back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterable, Mapping, Optional

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — TFRecord framing checksums
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset crc mask."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _packed_f64(field: int, values: Iterable[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in values)
    return _bytes(field, payload)


# ---------------------------------------------------------------------------
# Event / Summary / HistogramProto
# ---------------------------------------------------------------------------

def _histogram_proto(values: np.ndarray, bins: int = 30) -> bytes:
    """HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5,
    bucket_limit=6 (packed double), bucket=7 (packed double)."""
    v = np.asarray(values, np.float64).ravel()
    # Drop non-finite values: np.histogram raises on NaN/Inf, which would
    # stop the train loop here before the trainer's nan_check raises its
    # FloatingPointError, the real diagnostic (training divergence).
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,))
    counts, edges = np.histogram(v, bins=bins)
    # TB buckets: bucket[i] counted in (-inf, limit[0]], (limit[i-1], limit[i]]
    limits = list(edges[1:])
    limits[-1] = max(limits[-1], float(v.max()))
    return (_f64(1, float(v.min())) + _f64(2, float(v.max()))
            + _f64(3, float(v.size)) + _f64(4, float(v.sum()))
            + _f64(5, float((v * v).sum()))
            + _packed_f64(6, limits)
            + _packed_f64(7, [float(c) for c in counts]))


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    return _bytes(1, tag.encode()) + _f32(2, float(value))


def _histo_value(tag: str, values: np.ndarray) -> bytes:
    # Summary.Value: tag=1, histo=5 (HistogramProto)
    return _bytes(1, tag.encode()) + _bytes(5, _histogram_proto(values))


def _event(step: int, summary_values: Iterable[bytes] = (),
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    """Event: wall_time=1 (double), step=2 (int64), file_version=3,
    summary=5 (Summary with repeated value=1)."""
    body = _f64(1, time.time() if wall_time is None else wall_time)
    body += _int(2, int(step))
    if file_version is not None:
        body += _bytes(3, file_version.encode())
    vals = b"".join(_bytes(1, v) for v in summary_values)
    if vals:
        body += _bytes(5, vals)
    return body


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


class SummaryWriter:
    """Append-only tfevents writer: ``add_scalar`` / ``add_scalars`` /
    ``add_histogram``, flushed per event (small records, training cadence).

    One writer per split directory (train, validation), as the reference
    keeps two.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(0, file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write([_scalar_value(tag, value)], step)

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        self._write([_scalar_value(t, v) for t, v in scalars.items()], step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write([_histo_value(tag, np.asarray(values))], step)

    def _write(self, values, step: int) -> None:
        self._f.write(_record(_event(step, values)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# reader (for tests / offline inspection without tensorboard installed)
# ---------------------------------------------------------------------------

def read_events(path: str):
    """Parse a tfevents file back into [(step, {tag: value_or_histo})].

    Verifies TFRecord crcs; scalar values come back as floats, histograms
    as dicts with min/max/num/sum/bucket arrays.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == masked_crc32c(data[pos:pos + 8]), "bad header crc"
        payload = data[pos + 12:pos + 12 + length]
        (dcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert dcrc == masked_crc32c(payload), "bad data crc"
        pos += 16 + length
        out.append(_parse_event(payload))
    return out


def _parse_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            val = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 5:
            val = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 2:
            n = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[pos:pos + n]
            pos += n
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_event(buf: bytes):
    step = 0
    values = {}
    for field, wire, val in _parse_fields(buf):
        if field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:  # Summary
            for f2, _, v2 in _parse_fields(val):
                if f2 == 1:  # Summary.Value
                    tag, content = None, None
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            content = v3
                        elif f3 == 5 and w3 == 2:
                            content = _parse_histo(v3)
                    if tag is not None:
                        values[tag] = content
    return step, values


def _parse_histo(buf: bytes):
    h = {"bucket_limit": [], "bucket": []}
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    for field, wire, val in _parse_fields(buf):
        if field in names:
            h[names[field]] = val
        elif field in (6, 7) and wire == 2:
            arr = [struct.unpack_from("<d", val, i)[0]
                   for i in range(0, len(val), 8)]
            h["bucket_limit" if field == 6 else "bucket"] = arr
    return h
