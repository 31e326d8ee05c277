"""Paged KV-cache primitives (counterpart of ray_tpu/ops/paged_attention.py).

The KV cache is a pool of fixed-size blocks ``[num_blocks, block_size, KH,
hd]`` shared by every resident sequence; each sequence addresses its
context through a row of block ids. In the JAX package these are XLA
compositions, so plain PyTorch gather/scatter is their counterpart here.

The writes update the cache IN PLACE (JAX returns a new array; here a
copy of the whole pool per step would double its memory traffic) and
return it. Inactive slots, pad positions and block id -1 are dropped, so
they cannot overwrite blocks owned by live sequences, as JAX's
``mode="drop"`` scatter guarantees. The write never reads a kept-row
count on the host, so it does not wait for the device. All attention
math is f32.
"""
from __future__ import annotations

import math
from typing import Union

import torch

_NEG_INF = -1e30

IntLike = Union[int, torch.Tensor]


def paged_gather_kv(cache: torch.Tensor,
                    block_rows: torch.Tensor) -> torch.Tensor:
    """cache [N, Bs, KH, hd]; block_rows [B, M] (unused entries may hold
    any value — callers mask by length). Returns [B, M*Bs, KH, hd].
    Out-of-range ids are clipped: they gather rows the length mask
    removes."""
    b, m = block_rows.shape
    _, bs, kh, hd = cache.shape
    gathered = cache[block_rows.clamp(0, cache.shape[0] - 1)]
    return gathered.reshape(b, m * bs, kh, hd)


def _scatter_kept(cache: torch.Tensor, bids: torch.Tensor,
                  offs: torch.Tensor, new: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """cache[bids, offs] = new where ``keep`` (and the block id is in
    range), with every row written: a dropped row repeats the first kept
    row's index and value, or, when no row is kept, writes back what that
    index already holds. Duplicate indices so carry one value."""
    n, bs = cache.shape[:2]
    keep = keep & (bids >= 0) & (bids < n)
    flat = cache.view(n * bs, *cache.shape[2:])
    idx = bids.clamp(0, n - 1) * bs + offs
    val = new.to(cache.dtype)
    first = keep.to(torch.int32).argmax()     # 0 when nothing is kept
    dup_idx = idx[first]
    dup_val = torch.where(keep[first], val[first], flat[dup_idx])
    idx = torch.where(keep, idx, dup_idx)
    val = torch.where(keep.view(-1, *([1] * (val.dim() - 1))), val, dup_val)
    flat.index_copy_(0, idx, val)
    return cache


def paged_write_step(cache: torch.Tensor, block_rows: torch.Tensor,
                     positions: torch.Tensor, new: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """Write one token's K (or V) per batch slot, in place.

    cache [N, Bs, KH, hd]; block_rows [B, M]; positions [B] (the sequence
    index written); new [B, KH, hd]; active [B] bool. Inactive slots are
    dropped."""
    bs = cache.shape[1]
    b, m = block_rows.shape
    block_idx = (positions // bs).clamp(0, m - 1)
    bids = block_rows[torch.arange(b, device=block_rows.device), block_idx]
    return _scatter_kept(cache, bids, positions % bs, new, active)


def paged_write_prefill(cache: torch.Tensor, block_row: torch.Tensor,
                        seq: torch.Tensor, length: IntLike,
                        start: IntLike = 0) -> torch.Tensor:
    """Write a prompt's K (or V) into one block-table row, in place.

    cache [N, Bs, KH, hd]; block_row [M]; seq [S, KH, hd] (S is the
    prefill bucket); positions >= ``length`` are padding and dropped.
    seq[i] lands at sequence position start + i."""
    bs = cache.shape[1]
    pos = torch.arange(seq.shape[0], device=block_row.device) + start
    bids = block_row[(pos // bs).clamp(0, block_row.shape[0] - 1)]
    return _scatter_kept(cache, bids, pos % bs, seq, pos < start + length)


def paged_attention_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, block_row: torch.Tensor,
                            start: IntLike, length: IntLike) -> torch.Tensor:
    """Causal attention of a suffix over its full paged context: query i
    sits at position start + i and attends every cached position <= its
    own. q [S, H, hd]; block_row [M]. Rows at index >= ``length`` are
    garbage (not masked), as in the JAX package; ``length`` mirrors
    paged_write_prefill's signature. GQA (KH < H) broadcasts KV heads.
    Returns [S, H, hd] in q's dtype."""
    del length
    s, h, hd = q.shape
    kh = k_cache.shape[2]
    k = paged_gather_kv(k_cache, block_row[None])[0]    # [M*Bs, KH, hd]
    v = paged_gather_kv(v_cache, block_row[None])[0]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    ctx = k.shape[0]
    scores = torch.einsum("shd,chd->shc", q.float(), k.float()) / math.sqrt(hd)
    q_pos = start + torch.arange(s, device=q.device)
    mask = torch.arange(ctx, device=q.device)[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shc,chd->shd", probs, v.float())
    return out.to(q.dtype)


def paged_attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, block_rows: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One query token per slot over its paged context. q [B, H, hd];
    block_rows [B, M]; lengths [B] valid context positions (including the
    token written this step). Returns [B, H, hd] in q's dtype."""
    b, h, hd = q.shape
    kh = k_cache.shape[2]
    k = paged_gather_kv(k_cache, block_rows)           # [B, S, KH, hd]
    v = paged_gather_kv(v_cache, block_rows)
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    s = k.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.float())
    return out.to(q.dtype)
