"""Typed wire codec for cross-process control frames.

Replaces pickle on the RPC channels (rpc.py). The reference's control
plane is protobuf/gRPC end-to-end (ref: src/ray/protobuf/common.proto,
src/ray/rpc/grpc_server.h); `multiprocessing.connection`'s default pickle
framing meant anyone who could reach the head port with the cluster token
got arbitrary code execution on every node. This codec is structural: it
can ONLY produce the primitive types and the explicitly registered
control-plane structs below. A malformed or malicious frame raises
`WireDecodeError` at the framing layer — it is never evaluated.

User payloads (function blobs, serialized task args/results) remain
cloudpickle — but as opaque `bytes` inside frames; they are only
deserialized inside the worker that executes the user's code, which is the
boundary the reference draws too.

Format (version 1): 2-byte magic "RW", 1-byte version, then one encoded
value. Values are tag-prefixed: primitives carry fixed/length-prefixed
encodings; containers carry a u32 count; registered structs carry a u16
struct id and their registry-ordered field tuple.
"""
from __future__ import annotations

import struct
from enum import Enum
from typing import Any, Callable, Dict, Optional, Tuple

MAGIC = b"RW"
VERSION = 1

_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3       # int64
_T_BIGINT = 4    # arbitrary precision, length-prefixed two's complement
_T_FLOAT = 5
_T_STR = 6
_T_BYTES = 7
_T_LIST = 8
_T_TUPLE = 9
_T_DICT = 10
_T_SET = 11
_T_STRUCT = 12
_T_FROZENSET = 13

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# pre-compiled packers: struct.pack with a literal fmt re-parses the fmt
# string per call; these are the per-field hot path of every frame
_PACK_Q = struct.Struct("<q").pack
_PACK_I = struct.Struct("<I").pack
_PACK_D = struct.Struct("<d").pack
_PACK_H = struct.Struct("<H").pack
_UNPACK_Q = struct.Struct("<q").unpack
_UNPACK_I = struct.Struct("<I").unpack
_UNPACK_D = struct.Struct("<d").unpack
_UNPACK_H = struct.Struct("<H").unpack


class WireEncodeError(TypeError):
    pass


class WireDecodeError(ValueError):
    pass


# struct id -> (cls, encode(obj)->tuple, decode(tuple)->obj)
_BY_ID: Dict[int, Tuple[type, Callable, Callable]] = {}
_BY_CLS: Dict[type, int] = {}


def register_struct(sid: int, cls: type,
                    encode: Optional[Callable] = None,
                    decode: Optional[Callable] = None) -> None:
    """Register a control-plane type. Default encode/decode use dataclass
    field order (positional __init__)."""
    if sid in _BY_ID:
        raise ValueError(f"struct id {sid} already registered")
    if encode is None or decode is None:
        import dataclasses

        names = [f.name for f in dataclasses.fields(cls)]
        encode = encode or (lambda o, _n=tuple(names):
                            tuple(getattr(o, n) for n in _n))
        decode = decode or (lambda vals, _c=cls: _c(*vals))
    _BY_ID[sid] = (cls, encode, decode)
    _BY_CLS[cls] = sid


def _encode_value(buf: bytearray, v: Any) -> None:
    t = type(v)
    if v is None:
        buf.append(_T_NONE)
    elif t is bool:
        buf.append(_T_TRUE if v else _T_FALSE)
    elif t is int:
        if _I64_MIN <= v <= _I64_MAX:
            buf.append(_T_INT)
            buf += _PACK_Q(v)
        else:
            raw = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
            buf.append(_T_BIGINT)
            buf += _PACK_I(len(raw))
            buf += raw
    elif t is float:
        buf.append(_T_FLOAT)
        buf += _PACK_D(v)
    elif t is str:
        raw = v.encode()
        buf.append(_T_STR)
        buf += _PACK_I(len(raw))
        buf += raw
    elif t is bytes or t is bytearray or t is memoryview:
        raw = bytes(v) if t is not bytes else v
        buf.append(_T_BYTES)
        buf += _PACK_I(len(raw))
        buf += raw
    elif t is list:
        buf.append(_T_LIST)
        buf += _PACK_I(len(v))
        for item in v:
            _encode_value(buf, item)
    elif t is tuple:
        buf.append(_T_TUPLE)
        buf += _PACK_I(len(v))
        for item in v:
            _encode_value(buf, item)
    elif t is dict:
        buf.append(_T_DICT)
        buf += _PACK_I(len(v))
        for k, item in v.items():
            _encode_value(buf, k)
            _encode_value(buf, item)
    elif t is set or t is frozenset:
        buf.append(_T_SET if t is set else _T_FROZENSET)
        buf += _PACK_I(len(v))
        for item in v:
            _encode_value(buf, item)
    else:
        sid = _BY_CLS.get(t)
        if sid is None:
            # numpy SCALARS occasionally leak into resource/metric dicts;
            # coerce rather than force every caller to sanitize. Arrays
            # must raise WireEncodeError (a bare ValueError from .item()
            # would tear the channel down instead of dropping the frame)
            if type(v).__module__ == "numpy":
                if getattr(v, "ndim", 1) == 0:
                    _encode_value(buf, v.item())
                    return
                raise WireEncodeError(
                    "numpy arrays don't cross the control plane raw; "
                    "serialize to bytes first")
            if isinstance(v, Enum):
                raise WireEncodeError(
                    f"unregistered enum {t.__name__} on the control plane")
            raise WireEncodeError(
                f"type {t.__module__}.{t.__name__} is not wire-encodable; "
                f"register it in core/wire.py or send it as bytes")
        tmpl = getattr(v, "_wire_tmpl", None)
        if tmpl is not None:
            # template fast path (TaskSpec hot loop): constant fields of
            # a RemoteFunction's specs are pre-encoded once; per call
            # only the varying fields (task_id, args, ...) are walked —
            # ~5 value encodes instead of ~40 per pushed task
            buf.append(_T_STRUCT)
            buf += _PACK_H(sid)
            buf.append(_T_TUPLE)
            buf += _PACK_I(tmpl[0])
            for const, name in tmpl[1]:
                buf += const
                if name is not None:
                    _encode_value(buf, getattr(v, name))
            return
        _, enc, _ = _BY_ID[sid]
        buf.append(_T_STRUCT)
        buf += _PACK_H(sid)
        _encode_value(buf, tuple(enc(v)))


def make_struct_template(obj, varying: tuple) -> tuple:
    """Pre-encode the constant fields of a registered dataclass struct.

    Returns (field_count, ((const_bytes, varying_name_or_None), ...)) for
    the _wire_tmpl fast path in _encode_value. `varying` names are
    re-encoded per call from the live object; every other field is
    frozen to the bytes of its value on `obj` NOW — callers guarantee
    those fields are identical for every object carrying this template
    (RemoteFunction options are fixed at construction, so its specs
    qualify)."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(type(obj))]
    segs = []
    buf = bytearray()
    for name in names:
        if name in varying:
            segs.append((bytes(buf), name))
            buf = bytearray()
        else:
            _encode_value(buf, getattr(obj, name))
    segs.append((bytes(buf), None))
    return (len(names), tuple(segs))


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        p = self.pos
        if p + n > len(self.data):
            raise WireDecodeError("truncated frame")
        self.pos = p + n
        return self.data[p:p + n]

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return _UNPACK_I(self.take(4))[0]


_MAX_CONTAINER = 1 << 24  # 16M entries: sanity bound against forged counts
_MAX_DEPTH = 100  # a forged deep-nesting frame must not RecursionError
# through the read loop's drop-and-continue (RecursionError is not a
# WireDecodeError and would tear the channel down)


def _decode_value(r: _Reader, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise WireDecodeError("frame nesting too deep")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _UNPACK_Q(r.take(8))[0]
    if tag == _T_BIGINT:
        return int.from_bytes(r.take(r.u32()), "little", signed=True)
    if tag == _T_FLOAT:
        return _UNPACK_D(r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u32()).decode()
    if tag == _T_BYTES:
        return r.take(r.u32())
    if tag in (_T_LIST, _T_TUPLE, _T_SET, _T_FROZENSET):
        n = r.u32()
        if n > _MAX_CONTAINER:
            raise WireDecodeError(f"container too large: {n}")
        items = [_decode_value(r, depth + 1) for _ in range(n)]
        if tag == _T_LIST:
            return items
        if tag == _T_TUPLE:
            return tuple(items)
        return set(items) if tag == _T_SET else frozenset(items)
    if tag == _T_DICT:
        n = r.u32()
        if n > _MAX_CONTAINER:
            raise WireDecodeError(f"container too large: {n}")
        return {_decode_value(r, depth + 1): _decode_value(r, depth + 1)
                for _ in range(n)}
    if tag == _T_STRUCT:
        sid = _UNPACK_H(r.take(2))[0]
        entry = _BY_ID.get(sid)
        if entry is None:
            raise WireDecodeError(f"unknown struct id {sid}")
        vals = _decode_value(r, depth + 1)
        if not isinstance(vals, tuple):
            raise WireDecodeError("struct fields must be a tuple")
        _, _, dec = entry
        try:
            return dec(vals)
        except WireDecodeError:
            raise
        except Exception as e:
            raise WireDecodeError(f"bad struct {sid} fields: {e!r}") from e
    raise WireDecodeError(f"unknown tag {tag}")


def encode(obj: Any) -> bytes:
    buf = bytearray(MAGIC)
    buf.append(VERSION)
    try:
        _encode_value(buf, obj)
    except WireEncodeError:
        raise
    except Exception as e:
        # UnicodeEncodeError (surrogate strings), RecursionError (deep
        # payloads), etc. must surface as WireEncodeError: rpc.py's write
        # loop drops the frame for that type but tears the channel down
        # for anything else
        raise WireEncodeError(f"unencodable payload: {e!r}") from e
    return bytes(buf)


def decode_py(data: bytes) -> Any:
    """Pure-Python decoder — the semantics reference and the fallback
    when the C extension can't build."""
    if len(data) < 3 or data[:2] != MAGIC:
        raise WireDecodeError("bad magic: not a ray_tpu_torch control frame")
    if data[2] != VERSION:
        raise WireDecodeError(f"unsupported wire version {data[2]}")
    r = _Reader(data)
    r.pos = 3
    out = _decode_value(r)
    if r.pos != len(data):
        raise WireDecodeError("trailing bytes after frame")
    return out


def _struct_from_wire(sid: int, vals: tuple) -> Any:
    """Registry dispatch for the C decoder (same error contract as the
    _T_STRUCT branch of _decode_value)."""
    entry = _BY_ID.get(sid)
    if entry is None:
        raise WireDecodeError(f"unknown struct id {sid}")
    try:
        return entry[2](vals)
    except WireDecodeError:
        raise
    except Exception as e:
        raise WireDecodeError(f"bad struct {sid} fields: {e!r}") from e


decode = decode_py


def _try_native_decode() -> None:
    """Swap in the C decode path (ray_tpu_torch/native/wirefast.c) when it
    builds; ~5-10x on TaskSpec-shaped frames, bit-compatible by test."""
    global decode
    try:
        from ..native import load_wirefast

        mod = load_wirefast()
    except Exception:
        return
    if mod is None:
        return
    mod.init(WireDecodeError, _struct_from_wire)
    decode = mod.decode


# ---------------------------------------------------------------------------
# control-plane type registry
# ---------------------------------------------------------------------------


def _register_defaults() -> None:
    from . import ids as _ids
    from .gcs import (ActorInfo, ActorState, JobInfo, NodeInfo,
                      PlacementGroupInfo)
    from .object_ref import ObjectRef, _reconstruct_ref
    from .task_spec import SchedulingStrategy, TaskSpec, TaskType

    sid = 1
    for cls in (_ids.JobId, _ids.NodeId, _ids.WorkerId, _ids.ActorId,
                _ids.PlacementGroupId, _ids.TaskId, _ids.ObjectId):
        register_struct(sid, cls,
                        encode=lambda o: (o.binary(),),
                        decode=lambda vals, _c=cls: _c(vals[0]))
        sid += 1
    # enums (plain Enum, not IntEnum — encode .value)
    register_struct(16, TaskType,
                    encode=lambda o: (o.value,),
                    decode=lambda v: TaskType(v[0]))
    register_struct(17, ActorState,
                    encode=lambda o: (o.value,),
                    decode=lambda v: ActorState(v[0]))
    # deserializing a ref IS a borrow — route through the same constructor
    # the pickle path (__reduce__) used so the borrower protocol counts it
    register_struct(18, ObjectRef,
                    encode=lambda o: (o.id, o.owner, o._call_site),
                    decode=lambda v: _reconstruct_ref(*v))
    register_struct(19, SchedulingStrategy)
    register_struct(20, TaskSpec)
    register_struct(21, ActorInfo)
    register_struct(22, NodeInfo)
    register_struct(23, JobInfo)
    register_struct(24, PlacementGroupInfo)


_register_defaults()
_try_native_decode()
