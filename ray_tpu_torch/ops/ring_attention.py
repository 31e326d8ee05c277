"""Ring attention: sequence parallelism over a mesh axis (counterpart of
ray_tpu/ops/ring_attention.py, with its names).

The sequence is split over the axis (``"sp"``): each rank keeps its query
shard, and the key and value shards travel round the ring by the
differentiable ``ppermute`` of parallel/sharding/lower.py, one step at a
time. Each step's block attention returns its normalised output and its
per-row logsumexp in f32, and ``_merge`` folds it into the running pair,
so the result is exact attention over the whole sequence.

Call ``ring_attention`` inside a ``lower_shard_map`` body that binds the
axis, with q, k, v this rank's shards [B, S / n, H, D];
``ring_attention_sharded`` wraps that call over a MeshOwner.

As in the reference, the block products are plain products (einsum),
with no kernel: the merge differentiates through each block's lse, and
the flash backward kernel takes no lse cotangent.

Every rank builds the same autograd graph, so that the ranks' backwards
meet at the permutations' transposes in the same order: a block from a
rank later in the sequence (a wrapped shard, under the causal mask) is
computed, sent and received like any other, and masked out through its
lse (``torch.where`` on the rank's index), never skipped.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

_NEG_INF = -1e30


def _block_attn_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, causal: bool):
    """Attention over one (query shard, key/value shard) pair, returning
    the normalised output and the per-row logsumexp, in f32. Shapes
    [B, S, H, D] -> ([B, S, H, D], [B, H, S])."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where((rows + (sk - sq) >= cols)[None, None], s, _NEG_INF)
    m = s.amax(-1)                                             # [B, H, Q]
    p = torch.exp(s - m[..., None])
    denom = p.sum(-1).clamp_min(1e-30)                         # [B, H, Q]
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    lse = m + torch.log(denom)
    return out / denom.transpose(1, 2)[..., None], lse


def _merge(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
           lse2: torch.Tensor):
    """The numerically stable merge of two normalised attention partials."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)                                   # [B, H, Q]
    w2 = torch.exp(lse2 - m)
    tot = (w1 + w2).clamp_min(1e-30)

    def bc(w):                       # [B, H, Q] -> [B, Q, H, 1]
        return w.transpose(1, 2)[..., None]

    return (o1 * bc(w1) + o2 * bc(w2)) / bc(tot), m + torch.log(tot)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis_name``: q, k, v
    this rank's shards [B, S_local, H, D] (rank i of the axis holds
    positions [i * S_local, (i + 1) * S_local)), inside a
    ``lower_shard_map`` body that binds the axis. Returns this rank's
    shard of the output, in q's dtype. Differentiable: the permutations'
    transposes carry the key and value cotangents back round the ring."""
    from ..parallel.sharding import lower

    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n = lower.axis_size(axis_name)
    my = lower.axis_index(axis_name)
    # step 0: the diagonal block, our own keys, causal within the shard
    out, lse = _block_attn_lse(q, k, v, sm_scale, causal=causal)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for r in range(1, n):
        k = lower.ppermute(k, axis_name, perm, name="ring")
        v = lower.ppermute(v, axis_name, perm, name="ring")
        # after r steps we hold the shard of rank (my - r) mod n
        o_r, lse_r = _block_attn_lse(q, k, v, sm_scale, causal=False)
        if causal:
            # a wrapped shard (my - r < 0) lies in our future: its weight
            # goes to zero in the merge
            valid = torch.tensor(my >= r, device=lse_r.device)
            lse_r = torch.where(valid, lse_r, _NEG_INF)
        out, lse = _merge(out, lse, o_r, lse_r)
    return out.to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, axis_name: str = "sp",
                           causal: bool = True,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """``ring_attention`` over a MeshOwner ``mesh``'s ranks, as a
    shard_map with the sequence on ``axis_name``, the batch on dp/fsdp
    and the heads on tp (the reference's spec). As everywhere in the
    port's manual plane, q, k and v are this rank's shards and the result
    is its shard."""
    from ..parallel.mesh import PartitionSpec
    from ..parallel.sharding.lower import lower_shard_map

    spec = PartitionSpec(("dp", "fsdp"), axis_name, "tp", None)
    fn = lower_shard_map(
        functools.partial(ring_attention, axis_name=axis_name, causal=causal,
                          sm_scale=sm_scale),
        mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
