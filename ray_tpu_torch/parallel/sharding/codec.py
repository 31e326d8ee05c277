"""Quantized collectives inside a shard_map body (counterpart of
ray_tpu/parallel/sharding/codec.py, with its names).

The rank-local half of the EQuARX recipe (``parallel/quant.py`` is the
host half): a quantized reduce-scatter is

    quantize (per-block absmax) -> all_to_all (narrow payload + f32
    scales move over the wire) -> dequantize -> f32 sum

so the wire carries about a quarter of the f32 bytes while every sum runs
in f32 after dequantization. A plain reduce-scatter would sum in transit
(and sum int8 payloads into garbage), so the body decomposes it: the
all_to_all hands each rank the OTHER replicas' quantized images of *its*
chunk, and the sum runs locally, in rank order.

The collectives name only the axis the caller passes, which the enclosing
:func:`~.lower.lower_shard_map` must bind; :func:`lower_quantized_scatter`
wraps the body through ``lower_shard_map`` so the axis is always bound.
The payload and scales are bitwise the JAX package's on the same values
(int8, or e4m3 bits as uint8; f32 scales; ties-to-even rounding), the
grid the host codec lands on.

The customer is ``parallel.zero.make_zero_update_spmd(grad_codec=...)``,
which swaps its gradient psum_scatter for :func:`quantized_scatter_mean`.
"""
from __future__ import annotations

from typing import Callable

__all__ = [
    "dequantize_blocks", "lower_quantized_scatter", "quantize_blocks",
    "quantized_scatter_mean",
]

_INT8_MAX = 127.0
_E4M3_MAX = 448.0


def quantize_blocks(x, codec: str = "int8", block: int = 256):
    """Per-block quantization of ``x`` along its LAST dim (a multiple of
    ``block``) -> ``(payload, scales)``: payload int8 (or e4m3 bits as
    uint8) of shape ``x.shape[:-1] + (blocks, block)``, scales f32 with
    the last dim reduced to blocks. Deterministic ties-to-even rounding;
    an all-zero block keeps scale 0 and decodes to zeros."""
    import torch

    from ..quant import check_codec

    check_codec(codec)
    shape = tuple(x.shape)
    if shape[-1] % block:
        raise ValueError(f"last dim {shape[-1]} is not a multiple of the "
                         f"block {block}")
    blocks = x.reshape(shape[:-1] + (shape[-1] // block, block))
    # the scale is rounded in x's dtype before it widens, as in the JAX
    # package (a python float does not promote); the division is in f32.
    # The divisor is a tensor: CUDA divides by a python scalar through its
    # reciprocal, which is not the IEEE quotient
    absmax = blocks.abs().amax(dim=-1)
    top = torch.full_like(absmax, _INT8_MAX if codec == "int8"
                          else _E4M3_MAX)
    scales = (absmax / top).to(torch.float32)
    denom = torch.where(scales > 0.0, scales,
                        torch.ones_like(scales)).unsqueeze(-1)
    blocks = blocks.to(torch.float32)
    if codec == "int8":
        payload = torch.clamp(torch.round(blocks / denom), -_INT8_MAX,
                              _INT8_MAX).to(torch.int8)
    else:
        # the bits travel as uint8, as the JAX package bitcasts them; the
        # receiver views them back before it dequantizes
        payload = (blocks / denom).to(torch.float8_e4m3fn).view(torch.uint8)
    return payload, scales


def dequantize_blocks(payload, scales, codec: str = "int8"):
    """Inverse of :func:`quantize_blocks`: f32 out, the blocks merged back
    into the last dim."""
    import torch

    if codec == "int8":
        vals = payload.to(torch.float32)
    else:
        vals = payload.view(torch.float8_e4m3fn).to(torch.float32)
    out = vals * scales.unsqueeze(-1)
    return out.reshape(out.shape[:-2] + (-1,))


def quantized_scatter_mean(g, axis: str, world: int, codec: str = "int8",
                           block: int = 256):
    """Quantized reduce-scatter-mean INSIDE a shard_map body.

    ``g``: this rank's full flat gradient ``[world * chunk]`` (``axis``
    bound by the enclosing shard_map). Returns this rank's ``[chunk]``
    slice of the cross-replica MEAN. The wire carries the narrow payload
    and the per-block f32 scales; the sum over replicas runs in f32, in
    rank order, after dequantization.
    """
    import torch

    from .lower import all_to_all

    chunk = g.shape[0] // world
    gb = g.reshape(world, chunk)
    pad = (-chunk) % block
    if pad:
        gb = torch.nn.functional.pad(gb, (0, pad))
    payload, scales = quantize_blocks(gb, codec, block)
    # row r of payload is the image of rank r's chunk: all_to_all hands
    # each rank every replica's image of ITS chunk (row axis 0)
    wire_q = all_to_all(payload, axis, split_axis=0, concat_axis=0)
    wire_s = all_to_all(scales, axis, split_axis=0, concat_axis=0)
    deq = dequantize_blocks(wire_q, wire_s, codec)   # [world, chunk + pad]
    summed = deq[0].clone()
    for row in deq[1:]:
        summed += row
    return summed[:chunk] / world


def lower_quantized_scatter(owner, axis: str, codec: str = "int8",
                            block: int = 256, jit: bool = True) -> Callable:
    """A ``grads [1, n] -> mean shard [ceil(n / world)]`` callable over an
    owning mesh: the standalone spelling of the body for callers outside
    ``make_zero_update_spmd``. As under the reference's
    ``in_specs=P(axis)`` over a stacked ``[world, n]``, each rank passes
    its own row (``[1, n]``) and gets its chunk of the mean. ``axis`` must
    be one of the owner's mesh axes; ``jit`` is accepted and ignored."""
    from ..mesh import PartitionSpec as P
    from .lower import lower_shard_map

    world = owner.axis_size(axis)

    def body(g_stacked):
        return quantized_scatter_mean(g_stacked[0], axis, world,
                                      codec=codec, block=block)

    return lower_shard_map(body, owner, in_specs=(P(axis),),
                           out_specs=P(axis), axis_names=frozenset({axis}),
                           jit=jit)
