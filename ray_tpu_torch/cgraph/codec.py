"""Wire codecs for compiled-graph channel payloads.

Generalizes the host-collective codec (parallel/quant.py,
docs/COLLECTIVES.md) onto the cgraph data plane: a producer whose node
plan negotiated a codec walks its output value, replaces every LARGE
float array (>= :data:`MIN_QUANT_BYTES`, float16/bfloat16/float32/
float64, or a torch CPU tensor of float16/bfloat16/float32) with a
block-scaled :class:`~ray_tpu_torch.parallel.quant.QuantizedTensor` wire
record, and stamps the codec id into the
envelope's flag byte (channel.py bits 8-15). The consumer decodes
statelessly from that byte — no per-edge handshake, and an envelope
whose payload had nothing worth quantizing ships raw with flag 0, so
readers never pay a walk for small control traffic.

What this buys (the two spend sites named in ROADMAP item 2): pipeline
activation/cotangent hops between stage actors
(``CompiledPipelineEngine(wire_codec=...)``) and the disagg
prefill→decode KV shipment (``DisaggLLM(codec=...)``) cross the wire
at ~1/4 of their fp32 bytes. Error envelopes (FLAG_ERROR) are never
codec-encoded — fault propagation semantics are byte-identical with a
codec on.

Lossy by construction: values decode to their block-quantized image.
Callers opt in per graph/engine; integer/bool/bytes payloads and small
floats are always exact.
"""
from __future__ import annotations

import sys
from typing import Any, Optional, Tuple

import numpy as np

from ..core import serialization
from .channel import CODEC_IDS, CODEC_NAMES, FLAG_CODEC_MASK, \
    FLAG_CODEC_SHIFT

__all__ = ["MIN_QUANT_BYTES", "decode_value", "encode_value"]


def _q():
    # lazy, as in the JAX package: the codec paths only run where a codec
    # was negotiated
    from ..parallel import quant

    return quant

# arrays below this size ship raw: the scale overhead and the walk are
# not worth it, and small control values (losses, reports, token ids)
# stay bit-exact by construction
MIN_QUANT_BYTES = 4096

_FLOAT_NAMES = ("float16", "bfloat16", "float32", "float64")
# torch CPU tensors of these dtypes quantize too (numpy has no bfloat16,
# so the port ships bf16 KV as tensors)
_TENSOR_FLOAT_NAMES = ("torch.float16", "torch.bfloat16", "torch.float32")


def _quantizable(x) -> bool:
    # torch.Tensor where torch is imported (not yet while another thread
    # is importing it: no tensor exists before the class)
    tensor = getattr(sys.modules.get("torch"), "Tensor", None)
    if tensor is not None and isinstance(x, tensor):
        return (x.device.type == "cpu"
                and str(x.dtype) in _TENSOR_FLOAT_NAMES
                and x.numel() * x.element_size() >= MIN_QUANT_BYTES)
    dt = getattr(x, "dtype", None)
    if dt is None or getattr(x, "ndim", None) is None:
        return False
    try:
        if str(dt) not in _FLOAT_NAMES:
            return False
        return int(x.size) * np.dtype(str(dt)).itemsize >= MIN_QUANT_BYTES
    except Exception:
        return False


def _walk(value, fn):
    """Structurally rebuild dict/list/tuple containers, applying ``fn``
    to array leaves. Anything else passes through untouched (a pickled
    object graph with arrays buried in custom classes ships raw — the
    codec only chases the shapes channel traffic actually has:
    arrays, and containers of arrays)."""
    if isinstance(value, dict):
        return {k: _walk(v, fn) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_walk(v, fn) for v in value)
    if isinstance(value, list):
        return [_walk(v, fn) for v in value]
    return fn(value)


def encode_value(value: Any, codec: Optional[str]) -> Tuple[int, bytes]:
    """-> (codec_flag_bits, body). Bits are 0 (and the body a plain
    serialization) when no codec is set or nothing crossed the size
    floor — the reader then takes the exact fast path."""
    if codec is None:
        return 0, serialization.dumps(value)
    quant = _q()
    quant.check_codec(codec)
    hit = False

    def enc(x):
        nonlocal hit
        if _quantizable(x):
            hit = True
            return quant.quantize(
                x if str(x.dtype) in _TENSOR_FLOAT_NAMES else np.asarray(x),
                codec)
        return x

    transformed = _walk(value, enc)
    if not hit:
        return 0, serialization.dumps(value)
    return (CODEC_IDS[codec] << FLAG_CODEC_SHIFT,
            serialization.dumps(transformed))


def decode_value(flags: int, body: bytes) -> Any:
    """Inverse of :func:`encode_value`, driven entirely by the
    envelope's flag byte."""
    cid = (flags & FLAG_CODEC_MASK) >> FLAG_CODEC_SHIFT
    if cid == 0:
        return serialization.loads(body)
    if cid not in CODEC_NAMES:
        raise ValueError(
            f"envelope carries unknown wire-codec id {cid} — producer "
            f"and consumer disagree on the codec table")
    quant = _q()
    value = serialization.loads(body)

    def dec(x):
        if isinstance(x, quant.QuantizedTensor):
            return quant.dequantize(x)
        return x

    return _walk(value, dec)
