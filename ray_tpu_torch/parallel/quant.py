"""Block-scaled quantization codecs for slow-wire transfers (counterpart
of ray_tpu/parallel/quant.py; the payload and scales are bitwise those of
the JAX package on the same values).

EQuARX ("Efficient Quantized AllReduce in XLA", PAPERS.md) shows that
block-scaled low-precision collectives recover near-fp32 quality at a
fraction of the bytes: split the flat tensor into fixed-size blocks,
scale each block by its absmax so the payload fits the narrow format's
range, ship narrow payload + one fp32 scale per block, and accumulate
the *dequantized* (fp32) values at the reduce point. This module is the
host half of that recipe; in the port its user is the compiled-graph
channel codec (`cgraph/codec.py`), which quantizes large float arrays
inside envelope payloads (disagg prefill->decode KV blocks).

Codecs:

- ``"int8"``: symmetric linear int8; per-block ``scale = absmax / 127``,
  payload ``rint(x / scale)`` (ties-to-even — deterministic). 4 bytes ->
  1 + 4/block.
- ``"e4m3"``: float8 e4m3fn (4 exponent / 3 mantissa bits, max 448)
  through ``torch.float8_e4m3fn`` (round to nearest even, as ml_dtypes
  rounds in the JAX package); per-block ``scale = absmax / 448`` so every
  block spends the format's full dynamic range. Same wire size as int8.

Sources are numpy arrays or torch CPU tensors. Both go through fp32
before the division (a bf16 or f16 value widens exactly), so the payload
of a torch bf16 tensor equals that of the same bits in an ml_dtypes
bf16 array. Both dequantize to fp32 and cast back to the source dtype,
as a tensor when the source was a tensor (numpy has no bfloat16).

Design notes: scales are fp32 absmax — never rounded themselves;
all-zero blocks keep scale 0 and decode to exact zeros; payload + scales
ship as one picklable :class:`QuantizedTensor`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import sys

import numpy as np

__all__ = [
    "CODECS", "DEFAULT_BLOCK", "QuantizedTensor", "check_codec",
    "dequantize", "quantize", "wire_bytes",
]

CODECS = ("int8", "e4m3")
DEFAULT_BLOCK = 256

_INT8_MAX = 127.0
_E4M3_MAX = 448.0  # torch.finfo(torch.float8_e4m3fn).max


def check_codec(codec: Optional[str]) -> Optional[str]:
    """Validate a codec name (None passes through)."""
    if codec is None:
        return None
    if codec not in CODECS:
        raise ValueError(
            f"unknown codec {codec!r}; known codecs: {CODECS} "
            f"(None = full precision)")
    return codec


class QuantizedTensor:
    """One block-scaled quantized array: narrow payload + fp32 scales +
    the metadata to reconstruct shape/dtype. Picklable — this IS the
    wire record the host collectives and cgraph channels ship."""

    __slots__ = ("codec", "shape", "dtype", "block", "payload", "scales",
                 "tensor")

    def __init__(self, codec: str, shape: Tuple[int, ...], dtype: str,
                 block: int, payload: np.ndarray, scales: np.ndarray,
                 tensor: bool = False):
        self.codec = codec
        self.shape = tuple(shape)
        self.dtype = dtype       # numpy's name ("float32", "bfloat16")
        self.block = int(block)
        self.payload = payload   # int8 [nblocks, block] (e4m3: uint8 bits)
        self.scales = scales     # float32 [nblocks]
        self.tensor = bool(tensor)  # decode to a torch tensor

    def __getstate__(self):
        return (self.codec, self.shape, self.dtype, self.block,
                self.payload, self.scales, self.tensor)

    def __setstate__(self, st):
        (self.codec, self.shape, self.dtype, self.block,
         self.payload, self.scales, self.tensor) = st

    def nbytes(self) -> int:
        """Bytes this record puts on the wire (payload + scales)."""
        return int(self.payload.nbytes + self.scales.nbytes)

    def source_nbytes(self) -> int:
        """Bytes the full-precision original would have shipped."""
        return int(np.prod(self.shape, dtype=np.int64)
                   * _itemsize(self.dtype)) if self.shape else \
            _itemsize(self.dtype)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(codec={self.codec}, shape={self.shape},"
                f" dtype={self.dtype}, block={self.block},"
                f" wire={self.nbytes()}B)")


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _is_tensor(x) -> bool:
    # a tensor exists only where torch was imported: numpy-only callers
    # never pay the import (nor trip on a torch another thread is still
    # importing, whose Tensor does not exist yet)
    tensor = getattr(sys.modules.get("torch"), "Tensor", None)
    return tensor is not None and isinstance(x, tensor)


def _block_view(flat: np.ndarray, block: int) -> np.ndarray:
    """Pad to a block multiple and view as [nblocks, block]."""
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat.reshape(-1, block)


def _flat_f32(arr) -> Tuple[np.ndarray, Tuple[int, ...], str, bool]:
    """-> (flat fp32 values, shape, source dtype name, source is a
    tensor). A torch tensor must lie on the CPU."""
    if _is_tensor(arr):
        t = arr.detach()
        if t.device.type != "cpu":
            raise TypeError(
                f"quantize takes host tensors; move the {t.device} tensor "
                f"to the CPU first")
        flat = t.reshape(-1).float().numpy()
        return (np.ascontiguousarray(flat), tuple(t.shape),
                str(t.dtype).replace("torch.", ""), True)
    a = np.asarray(arr)
    flat = np.ascontiguousarray(a, dtype=np.float32).ravel()
    return flat, a.shape, str(a.dtype), False


def quantize(arr, codec: str = "int8",
             block: int = DEFAULT_BLOCK) -> QuantizedTensor:
    """Block-scaled quantization of an array-like or a torch CPU tensor
    to a wire record.

    Deterministic: same input bytes -> same output bytes, on every
    host (ties-to-even rounding in both codecs).
    """
    check_codec(codec)
    flat, shape, src_dtype, tensor = _flat_f32(arr)
    blocks = _block_view(flat, block)
    absmax = np.max(np.abs(blocks), axis=1)
    if codec == "int8":
        scales = (absmax / _INT8_MAX).astype(np.float32)
        # all-zero blocks: scale 0 -> divide-by-1, payload exact zeros
        denom = np.where(scales > 0.0, scales, 1.0)[:, None]
        q = np.rint(blocks / denom)
        payload = np.clip(q, -_INT8_MAX, _INT8_MAX).astype(np.int8)
    else:  # e4m3
        import torch

        scales = (absmax / _E4M3_MAX).astype(np.float32)
        denom = np.where(scales > 0.0, scales, 1.0)[:, None]
        scaled = np.ascontiguousarray(blocks / denom, dtype=np.float32)
        payload = torch.from_numpy(scaled).to(
            torch.float8_e4m3fn).view(torch.uint8).numpy()
    return QuantizedTensor(codec, shape, src_dtype, block, payload,
                           scales, tensor)


def dequantize(qt: QuantizedTensor):
    """Wire record -> array in the source shape/dtype (a torch tensor
    when the source was one). Values decode in fp32 (payload *
    per-block scale) before the final dtype cast."""
    if qt.codec == "int8":
        vals = qt.payload.astype(np.float32)
    else:
        import torch

        # a copy: the payload may be a read-only view of a channel
        vals = torch.from_numpy(np.array(qt.payload)).view(
            torch.float8_e4m3fn).float().numpy()
    out = (vals * qt.scales[:, None]).ravel()
    n = int(np.prod(qt.shape, dtype=np.int64)) if qt.shape else 1
    out = out[:n].reshape(qt.shape)
    if qt.tensor:
        import torch

        return torch.from_numpy(np.ascontiguousarray(out)).to(
            getattr(torch, qt.dtype))
    return out.astype(np.dtype(qt.dtype), copy=False)


def wire_bytes(value) -> int:
    """Bytes a collective contribution occupies on the wire: quantized
    records report payload+scales, arrays report nbytes, scalars their
    numpy size; opaque values report 0 (counted nowhere rather than
    paying a serialization just to measure)."""
    if isinstance(value, QuantizedTensor):
        return value.nbytes()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if _is_tensor(value):
        return int(value.numel() * value.element_size())
    if isinstance(value, (int, float, np.number, bool)):
        return int(np.asarray(value).nbytes)
    try:
        a = np.asarray(value)
        if a.dtype != object:
            return int(a.nbytes)
    except Exception:
        pass
    return 0
