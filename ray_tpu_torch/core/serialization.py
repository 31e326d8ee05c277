"""Serialization: cloudpickle with pickle-5 out-of-band buffers.

Equivalent of the reference's serialization context
(ref: python/ray/_private/serialization.py — pickle5 + out-of-band buffers so
large numpy/arrow payloads are written once into the object store without an
extra copy; ObjectRefs found inside values are tracked for the borrowing
protocol).

Wire format of a sealed object:
    [u32 meta_len][meta pickle][u32 nbuf][u64 len_i]*nbuf [buffer bytes...]
meta is the cloudpickle of the value with PickleBuffer placeholders.

The cloudpickle is the port's vendored copy (``_vendor/cloudpickle``). A
torch CPU tensor travels like a numpy array: its bytes as one out-of-band
buffer, its dtype and shape in the meta, so a KV shipment is written once
into the channel or the store. A tensor on the card is never pickled: the
sender moves it to the host first.
"""
from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, List, Tuple

from .._vendor import cloudpickle

_PROTOCOL = 5


class SerializedObject:
    """A serialized value: a small metadata pickle plus zero-copy buffers."""

    __slots__ = ("meta", "buffers", "contained_refs")

    def __init__(self, meta: bytes, buffers: List[memoryview], contained_refs: list):
        self.meta = meta
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return (
            8
            + len(self.meta)
            + 8 * len(self.buffers)
            + sum(b.nbytes for b in self.buffers)
        )

    def write_into(self, dest: memoryview) -> int:
        off = 0
        struct.pack_into("<I", dest, off, len(self.meta))
        off += 4
        dest[off : off + len(self.meta)] = self.meta
        off += len(self.meta)
        struct.pack_into("<I", dest, off, len(self.buffers))
        off += 4
        for b in self.buffers:
            struct.pack_into("<Q", dest, off, b.nbytes)
            off += 8
        for b in self.buffers:
            n = b.nbytes
            dest[off : off + n] = b.cast("B")
            off += n
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes)
        self.write_into(memoryview(out))
        return bytes(out)


class _RefTrackingPickler(cloudpickle.CloudPickler):
    """Tracks ObjectRefs serialized inside the value (borrowing protocol
    hook). Defined once at module level — building a class object per
    serialize() call cost ~15us on the task hot path."""

    def __init__(self, f, contained_refs, **kw):
        super().__init__(f, **kw)
        self._contained_refs = contained_refs

    def persistent_id(self, obj):  # noqa: N802
        return None

    def reducer_override(self, obj):
        from .object_ref import ObjectRef  # local import to avoid cycle

        if isinstance(obj, ObjectRef):
            self._contained_refs.append(obj)
        # a tensor exists only where torch was imported: no import here
        tensor = _torch_tensor_type()
        if tensor is not None and isinstance(obj, tensor):
            return _reduce_tensor(obj)
        sup = super()
        return sup.reducer_override(obj) \
            if hasattr(sup, "reducer_override") else NotImplemented


def _torch_tensor_type():
    """``torch.Tensor`` where torch is imported, else None — also while
    another thread is still importing it: the module is in sys.modules
    from the start of its import, its ``Tensor`` only later, and no
    tensor can exist before it. (Reading the attribute off a half-imported
    torch raised inside the pickler, so every value this process
    serialized in that window failed, the replies of actor calls
    included, and their callers waited forever.)"""
    return getattr(sys.modules.get("torch"), "Tensor", None)


def _reduce_tensor(t):
    """A torch CPU tensor -> (_rebuild_tensor, (raw bytes as one
    PickleBuffer, dtype name, shape)). Autograd state does not travel."""
    if t.device.type != "cpu":
        raise TypeError(
            f"cannot serialize a tensor on {t.device}: move it to the host "
            f"first (.cpu())")
    t = t.detach().contiguous()
    raw = t.reshape(-1).view(sys.modules["torch"].uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw),
                             str(t.dtype).replace("torch.", ""),
                             tuple(t.shape))


def _rebuild_tensor(buf, dtype: str, shape):
    """Inverse of :func:`_reduce_tensor`: a fresh tensor that owns a copy
    of the bytes (the buffer may be a read-only view of shared memory)."""
    import numpy as np
    import torch

    t = torch.empty(shape, dtype=getattr(torch, dtype))
    t.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(
        buf, dtype=np.uint8)
    return t


def serialize(value: Any) -> SerializedObject:
    import io

    buffers: List[pickle.PickleBuffer] = []
    contained_refs: list = []
    f = io.BytesIO()
    p = _RefTrackingPickler(f, contained_refs, protocol=_PROTOCOL,
                            buffer_callback=buffers.append)
    p.dump(value)
    views = [b.raw() for b in buffers]
    return SerializedObject(f.getvalue(), views, contained_refs)


def deserialize(data: memoryview | bytes) -> Any:
    mv = memoryview(data)
    off = 0
    (meta_len,) = struct.unpack_from("<I", mv, off)
    off += 4
    meta = mv[off : off + meta_len]
    off += meta_len
    (nbuf,) = struct.unpack_from("<I", mv, off)
    off += 4
    lens = []
    for _ in range(nbuf):
        (n,) = struct.unpack_from("<Q", mv, off)
        off += 8
        lens.append(n)
    bufs = []
    for n in lens:
        bufs.append(mv[off : off + n])
        off += n
    return pickle.loads(bytes(meta), buffers=bufs)


def dumps(value: Any) -> bytes:
    """Serialize to a single contiguous byte string (inline path)."""
    return serialize(value).to_bytes()


def loads(data: bytes | memoryview) -> Any:
    return deserialize(data)
