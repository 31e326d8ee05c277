"""The explicit tensor-parallel (Megatron) split of the serving models.

The JAX package's tp engine hands the unchanged model to GSPMD, which
partitions it. Eager torch has no partitioner, so the port writes the
split out, once, here and in the models' ``_mm_row`` / ``_embed`` /
head methods:

- Q/K/V and the FFN up/gate products are column-parallel: each rank holds
  its heads' (or hidden columns') output slice of the weight and
  computes its slice of the activations, no communication.
- The attention output (``w_o`` / ``w_proj``) and FFN down (``w_down`` /
  ``w_out``) products are row-parallel: each rank multiplies its slice
  of the activations by its rows of the weight, the partial products are
  accumulated in f32 and summed by one all-reduce, then rounded once to
  the compute dtype (the unsplit product rounds its f32 accumulation
  once too).
- The embedding and the LM head are split by vocabulary rows: a masked
  lookup plus an all-reduce, and each rank's logits slice gathered. In
  training the logits stay split: the cross entropy all-reduces each
  row's max and sum of exponentials and takes the gold logit from the
  rank that holds it (``nll_sum``).

With grad enabled the split trains, as Megatron's pair of collectives
(``parallel.sharding.lower``'s differentiable ``group_all_reduce`` and
``group_pvary``, JAX's transposes): a row-parallel sum (and the
embedding's) is the identity in the backward, and the input of a
column-parallel product (``enter``) sums its cotangent over the group.
So each rank's gradient of a split parameter is the full gradient's
block, and of a replicated one the full gradient. The all-reduce is a
dispatcher op that a selective checkpoint saves, so a recompute never
runs a collective again. Under ``no_grad`` (serving) the sums are
in-place all-reduces, as cheap as before.

Heads are assigned in blocks of ``ceil(H / tp)`` per rank. Where H does
not divide by tp the last ranks get zero heads (zero q/k/v columns and
zero output rows), which enter the row-parallel sum as exact zeros: each
real head enters it exactly once, which is what GSPMD's padding
computes. KV heads follow the query heads a rank holds (``KVHeadLayout``):
under GQA a rank holds the KV heads its query heads read, replicated
across ranks when there are fewer KV heads than ranks. The device KV
cache is split the same way, by KV head, every block on every rank;
``SpecLayout.kv_cache_blocks`` (each chip 1/tp of the blocks, all heads)
would need KV traffic between ranks at every step of a head-split
forward.

GPT's fused ``w_qkv`` [L, D, 3D] holds q, k and v side by side. The JAX
package's spec ``P(None, None, "tp")`` cuts it into contiguous column
chunks, which GSPMD can re-split; a rank here takes its heads out of each
of q, k and v (viewed as [L, D, 3, H, hd]), so its local shard is not the
reference's contiguous chunk. ``b_qkv`` likewise.

Collectives go over the tp group. With gloo (the backend of two ranks
on one card: NCCL refuses two ranks on one device) ``all_reduce`` takes a
CUDA tensor and stages it through the host itself; ``all_gather`` has no
CUDA path in gloo, so the logits are staged to the host here before it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def matmul_f32(x, w):
    """x [..., K] @ w [K, N] accumulated and returned in f32: a cuBLAS
    product with an f32 output for 16-bit operands on CUDA, the f32
    product of the upcast operands elsewhere (products of 16-bit values
    are exact in f32)."""
    import torch

    if x.device.type == "cuda" and x.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


@dataclass(frozen=True)
class KVHeadLayout:
    """The global query and KV heads one rank holds, in local order; -1
    marks a zero (padding) head."""
    q_heads: Tuple[int, ...]
    kv_heads: Tuple[int, ...]


def head_layout(n_head: int, n_kv_head: int, size: int,
                rank: int) -> KVHeadLayout:
    """Rank ``rank``'s heads of ``size``: ``ceil(H / size)`` consecutive
    query heads (-1 past H), and the KV heads they read laid out so that
    local query head j reads local KV head j // (Hl / KHl), the grouping
    ``repeat_interleave`` gives. Where no contiguous grouping exists (GQA
    over padded heads, or groups that straddle ranks) every local query
    head gets its own copy of its KV head."""
    hl = ceil_div(n_head, size)
    q = tuple(g if g < n_head else -1 for g in range(rank * hl,
                                                      (rank + 1) * hl))
    rep = n_head // n_kv_head
    if rep == 1:
        kv = q
    elif n_head % size == 0 and hl % rep == 0:
        kv = tuple(range(rank * hl // rep, (rank + 1) * hl // rep))
    elif n_head % size == 0 and rep % hl == 0:
        kv = (rank * hl // rep,)
    else:
        kv = tuple(g // rep if g >= 0 else -1 for g in q)
    return KVHeadLayout(q, kv)


class TensorParallel:
    """One rank's view of a tensor-parallel group: its rank, the group
    size, the process group, and the shard and collective helpers the
    models' tp forward uses. ``group=None`` with ``size=1`` is the
    unsplit model (the helpers then do nothing)."""

    def __init__(self, rank: int, size: int, group=None):
        if size > 1 and group is None:
            raise ValueError("a tensor-parallel group of size > 1 needs a "
                             "process group")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} not in a group of {size}")
        self.rank, self.size, self.group = int(rank), int(size), group

    @classmethod
    def from_owner(cls, owner, axis: str = "tp") -> "TensorParallel":
        """The tp axis of a MeshOwner's mesh, for this rank."""
        coord = owner.coordinate()
        if coord is None:
            raise ValueError(f"this rank is not on mesh {owner.name!r}")
        size = owner.axis_size(axis)
        return cls(coord[axis], size,
                   owner.mesh.get_group(axis) if size > 1 else None)

    # -- shards ---------------------------------------------------------------

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of n items split in blocks of
        ceil(n / size); hi may pass n (those items are zero padding)."""
        per = ceil_div(n, self.size)
        return self.rank * per, (self.rank + 1) * per

    def take_block(self, x, dim: int):
        """This rank's block of ``x`` along ``dim``, zero-padded past its
        end, as a tensor of its own."""
        import torch

        lo, hi = self.block(x.shape[dim])
        n = x.shape[dim]
        part = x.narrow(dim, min(lo, n), max(0, min(hi, n) - lo))
        if hi <= n:
            return part.clone()
        pad = list(x.shape)
        pad[dim] = hi - max(lo, n)
        return torch.cat([part, x.new_zeros(pad)], dim=dim)

    @staticmethod
    def take_heads(x, dim: int, heads, head_dim: int):
        """Heads ``heads`` (global ids, -1 a zero head) out of ``dim`` of
        ``x``, laid out as heads x head_dim, as a tensor of its own."""
        import torch

        xs = x.unflatten(dim, (-1, head_dim))
        idx = torch.tensor([max(h, 0) for h in heads], device=x.device)
        out = xs.index_select(dim, idx)
        pad = [i for i, h in enumerate(heads) if h < 0]
        if pad:
            out.index_fill_(dim, torch.tensor(pad, device=x.device), 0)
        return out.flatten(dim, dim + 1)

    # -- collectives ----------------------------------------------------------

    def embed(self, table, tokens, n: int):
        """Rows ``tokens`` of an n-row table split by rows over the group
        (``table`` is this rank's block), in f32: each rank looks up the
        tokens in its block, zeros the others, and the all-reduce adds
        exact zeros to the one rank's row. Its backward gives each rank's
        block the gradient of its own rows, zero elsewhere."""
        import torch
        import torch.nn.functional as F

        lo, hi = self.block(n)
        local = tokens - lo
        hit = (local >= 0) & (local < hi - lo)
        rows = F.embedding(local.clamp(0, hi - lo - 1), table).float()
        return self.all_reduce_f32(torch.where(hit[..., None], rows, 0.0),
                                   name="tp.embed")

    def all_reduce_f32(self, x, name: str = "tp.psum"):
        """Sum over the group, in f32 (``x`` is upcast first); with grad
        enabled the differentiable sum, recorded under ``name``
        (``lower.collective_stats``)."""
        return self._all_reduce(x.float(), "sum", name)

    def _all_reduce(self, x, op: str, name: str):
        import torch
        import torch.distributed as dist

        if self.size == 1:
            return x
        x = x.contiguous()
        if torch.is_grad_enabled():
            from .lower import group_all_reduce

            return group_all_reduce(x, self.group, name=name, op=op)
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return x

    def enter(self, x):
        """``x`` entering a column-parallel product (or the vocabulary
        split of the head): the identity, whose backward sums the
        cotangent over the group (Megatron's f, JAX's pvary)."""
        if self.size == 1:
            return x
        from .lower import group_pvary

        return group_pvary(x, self.group, name="tp.enter")

    def nll_sum(self, logits, targets, n: int):
        """The summed cross entropy of rows of logits split by vocabulary
        over the group: ``logits`` [T, n / size] is this rank's f32 block
        of rows n wide (zero-padding columns past n take no part),
        ``targets`` [T] global ids. Each row's max and sum of
        exponentials are all-reduced in f32, and its gold logit comes
        from the rank whose block holds the target, so no rank holds a
        whole row. Differentiable, the same value on every rank."""
        import torch

        lo, hi = self.block(n)
        width = hi - lo
        if hi > n:
            cols = torch.arange(lo, hi, device=logits.device)
            logits = torch.where(cols < n, logits, float("-inf"))
        m = self._all_reduce(logits.detach().amax(-1), "max", "tp.max")
        total = self.all_reduce_f32(
            torch.exp(logits - m[:, None]).sum(-1), name="tp.sumexp")
        local = targets - lo
        hit = (local >= 0) & (local < width)
        gold = logits.gather(-1, local.clamp(0, width - 1)[:, None])[:, 0]
        gold = self.all_reduce_f32(torch.where(hit, gold, 0.0),
                                   name="tp.gold")
        return (m + torch.log(total) - gold).sum()

    def gather_last(self, x, n: Optional[int] = None):
        """Every rank's ``x`` concatenated along the last dimension (cut
        to ``n`` when given), on the host: gloo's all_gather has no CUDA
        path, so a CUDA ``x`` is staged to the host first."""
        import torch
        import torch.distributed as dist

        host = x.detach().to("cpu").contiguous()
        if self.size > 1:
            parts: List = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            host = torch.cat(parts, dim=-1)
        return host if n is None else host[..., :n]
