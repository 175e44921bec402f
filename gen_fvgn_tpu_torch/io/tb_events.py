"""Dependency-free TensorBoard event writer (scalars and histograms).

Counterpart of `gen_fvgn_tpu/io/tb_events.py` (`EventWriter`, `crc32c`,
the scalar and histogram protos): a TFRecord stream of hand-encoded
`Event` protobufs (varint / fixed wire encoding, masked CRC32C framing),
NumPy only, byte for byte the JAX package's for the same events and wall
times.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Sequence

import numpy as np

# ---- CRC32C (Castagnoli, reflected poly 0x82F63B78) ----

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    for byte in data:
        crc = table[(int(crc) ^ byte) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---- minimal protobuf wire encoding ----


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _string(field: int, text: str) -> bytes:
    return _bytes(field, text.encode("utf-8"))


def _packed_f64(field: int, values: Sequence[float]) -> bytes:
    data = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes(field, data)


def _histogram_proto(values: np.ndarray, bins: int = 30):
    """HistogramProto: min/max/num/sum/sum_squares + explicit buckets.
    Returns None when no finite values exist — the caller warns instead of
    logging a fake healthy-looking histogram (an all-NaN gradient tree is
    exactly the divergence signal histograms exist to surface)."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    lo, hi = float(v.min()), float(v.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, edges = np.histogram(v, bins=bins, range=(lo, hi))
    msg = (_f64(1, lo) + _f64(2, hi) + _f64(3, float(v.size))
           + _f64(4, float(v.sum())) + _f64(5, float((v * v).sum()))
           + _packed_f64(6, edges[1:]) + _packed_f64(7, counts))
    return msg


class EventWriter:
    """Append-only events.out.tfevents writer (one per run directory)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(path, "wb")
        self.path = path
        # header event: file_version
        self._write_event(_f64(1, time.time())
                          + _string(3, "brain.Event:2"))

    def _write_event(self, event_bytes: bytes) -> None:
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        value_msg = _string(1, tag) + _f32(2, float(value))
        summary = _bytes(1, value_msg)
        self._write_event(_f64(1, time.time()) + _int(2, int(step))
                          + _bytes(5, summary))

    def add_histogram(self, tag: str, values, step: int,
                      bins: int = 30) -> None:
        histo = _histogram_proto(np.asarray(values), bins)
        if histo is None:
            import warnings
            warnings.warn(f"histogram {tag!r} at step {step} has no finite "
                          "values (all NaN/Inf) — not logged")
            return
        value_msg = _string(1, tag) + _bytes(5, histo)
        summary = _bytes(1, value_msg)
        self._write_event(_f64(1, time.time()) + _int(2, int(step))
                          + _bytes(5, summary))

    def close(self) -> None:
        self._f.close()
