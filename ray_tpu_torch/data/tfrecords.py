"""TFRecord datasource — no TensorFlow dependency.

The reference reads TFRecords through tf.data / tf.train.Example (ref:
python/ray/data/read_api.py read_tfrecords,
data/_internal/datasource/tfrecords_datasource.py). This image ships no
TensorFlow, so both layers are implemented directly:

- the TFRecord framing: each record is
  u64 length | u32 masked-crc32c(length) | data | u32 masked-crc32c(data)
- the tf.train.Example payload: a protobuf Example{features: Features{
  feature: map<string, Feature>}} where Feature is a oneof
  {bytes_list, float_list, int64_list}. The subset of protobuf wire
  format needed (varint, length-delimited, fixed32/64, packed repeats)
  is ~100 lines and decoded here without any protobuf runtime.

CRCs are verified on read (torn/corrupt records raise), matching the
reference's integrity behavior.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# crc32c (Castagnoli); zlib.crc32 is crc32b — wrong polynomial for
# TFRecords, so a small table-driven implementation lives here
_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    tbl = _CRC_TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# protobuf wire-format subset
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, pos = _read_varint(buf, pos)
        elif wt == 1:  # fixed64
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _decode_feature(buf: bytes):
    """tf.train.Feature: oneof bytes_list=1 / float_list=2 / int64_list=3."""
    for field, _wt, v in _fields(buf):
        if field == 1:  # BytesList{value: repeated bytes = 1}
            return [fv for f2, _w, fv in _fields(v) if f2 == 1]
        if field == 2:  # FloatList{value: repeated float = 1, packed}
            out: List[float] = []
            for f2, w2, fv in _fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    out.extend(struct.unpack(f"<{len(fv) // 4}f", fv))
                else:
                    out.append(struct.unpack("<f", fv)[0])
            return out
        if field == 3:  # Int64List{value: repeated int64 = 1, packed}
            out = []
            for f2, w2, fv in _fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:
                    pos = 0
                    while pos < len(fv):
                        iv, pos = _read_varint(fv, pos)
                        out.append(iv - (1 << 64) if iv >= (1 << 63) else iv)
                else:
                    out.append(fv - (1 << 64) if fv >= (1 << 63) else fv)
            return out
    return []


def decode_example(buf: bytes) -> Dict[str, Any]:
    """tf.train.Example -> {name: list-of-values}."""
    out: Dict[str, Any] = {}
    for field, _wt, v in _fields(buf):          # Example{features = 1}
        if field != 1:
            continue
        for f2, _w2, fv in _fields(v):          # Features{feature map = 1}
            if f2 != 1:
                continue
            name = value = None
            for f3, _w3, mv in _fields(fv):     # map entry {key=1, value=2}
                if f3 == 1:
                    name = mv.decode()
                elif f3 == 2:
                    value = _decode_feature(mv)
            if name is not None:
                out[name] = value
    return out


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: value(s)} -> tf.train.Example bytes (bytes/float/int64 lists
    inferred from the python types) — the test/round-trip half."""
    def ld(out: bytearray, field: int, payload: bytes) -> None:
        _write_varint(out, (field << 3) | 2)
        _write_varint(out, len(payload))
        out += payload

    fmap = bytearray()
    for name, vals in features.items():
        if not isinstance(vals, (list, tuple, np.ndarray)):
            vals = [vals]
        inner = bytearray()
        first = vals[0] if len(vals) else 0
        if isinstance(first, (bytes, str)):
            blist = bytearray()
            for v in vals:
                ld(blist, 1, v.encode() if isinstance(v, str) else v)
            ld(inner, 1, bytes(blist))
        elif isinstance(first, (float, np.floating)):
            ld(inner, 2, _float_list([float(v) for v in vals]))
        else:
            ints = bytearray()
            _write_varint(ints, (1 << 3) | 2)
            payload = bytearray()
            for v in vals:
                _write_varint(payload, int(v) & ((1 << 64) - 1))
            _write_varint(ints, len(payload))
            ints += payload
            ld(inner, 3, bytes(ints))
        entry = bytearray()
        ld(entry, 1, name.encode())
        ld(entry, 2, bytes(inner))
        ld(fmap, 1, bytes(entry))
    out = bytearray()
    ld(out, 1, bytes(fmap))
    return bytes(out)


def _float_list(vals) -> bytes:
    """FloatList message body: packed repeated float, field 1."""
    packed = struct.pack(f"<{len(vals)}f", *vals)
    out = bytearray()
    _write_varint(out, (1 << 3) | 2)
    _write_varint(out, len(packed))
    out += packed
    return bytes(out)


# ---------------------------------------------------------------------------
# record-level IO
# ---------------------------------------------------------------------------


def read_tfrecord_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,), (crc,) = (struct.unpack("<Q", header[:8]),
                                 struct.unpack("<I", header[8:]))
            if _masked_crc(header[:8]) != crc:
                raise ValueError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record")
            (dcrc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(data) != dcrc:
                raise ValueError(f"{path}: corrupt data crc")
            yield data


def write_tfrecord_file(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for data in records:
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def tfrecords_to_block(path: str) -> Dict[str, np.ndarray]:
    """One TFRecord file of Examples -> a columnar block. Single-value
    features become scalar columns; multi-value become object columns."""
    rows = [decode_example(rec) for rec in read_tfrecord_file(path)]
    if not rows:
        return {}
    # union of feature names across ALL rows — tf.train.Example features
    # are optional, so a key absent from the first record must not drop
    # the whole column
    keys: Dict[str, None] = {}
    for r in rows:
        for k in r:
            keys.setdefault(k)
    cols: Dict[str, list] = {k: [] for k in keys}
    for r in rows:
        for k in cols:
            v = r.get(k)
            cols[k].append(v[0] if isinstance(v, list) and len(v) == 1 else v)
    out: Dict[str, np.ndarray] = {}
    for k, vals in cols.items():
        try:
            arr = np.asarray(vals)
            if arr.dtype == object:
                raise ValueError
        except Exception:
            arr = np.empty(len(vals), object)
            for i, v in enumerate(vals):
                arr[i] = v
        out[k] = arr
    return out
