"""DataIterator / shard consumption (counterpart of
ray_tpu/data/iterator.py).

Equivalent of the reference's DatasetIterator (ref:
python/ray/data/iterator.py — iter_batches/iter_rows over streamed blocks;
train/_internal/session.py:470 get_dataset_shard). A DataShard is what a
Train worker receives: a picklable handle to a list of block refs (refs
serialize as borrows, so the blocks stay alive while any worker holds the
shard).
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch

from .block import (Block, block_concat, block_num_rows, block_select,
                    block_slice, block_to_batch, block_to_rows)


class Shardable(abc.ABC):
    """The sharding contract the Train layer consumes (`DataParallelTrainer`
    ``datasets=``): ``split_shards(n)`` returns exactly ``n``
    :class:`DataShard` handles whose rows are **disjoint** and
    **exhaustive** — every row of the dataset lands in exactly one
    shard. ``Dataset`` implements it; anything else that wants to feed
    Train workers per-rank slices implements/registers this instead of
    relying on a ``hasattr`` duck-type."""

    @abc.abstractmethod
    def split_shards(self, n: int, *, equal: bool = True,
                     locality_hints=None) -> List["DataShard"]:
        """Split into exactly ``n`` disjoint, exhaustive shards."""


def _iter_batches_from_blocks(blocks: Iterator[Block], batch_size: Optional[int],
                              batch_format: str, drop_last: bool,
                              local_shuffle_seed: Optional[int]) -> Iterator[Any]:
    if batch_size is None:
        for b in blocks:
            if block_num_rows(b):
                yield block_to_batch(b, batch_format)
        return
    carry: Optional[Block] = None
    rng = (np.random.default_rng(local_shuffle_seed)
           if local_shuffle_seed is not None else None)
    for b in blocks:
        if rng is not None and block_num_rows(b):
            b = block_select(b, rng.permutation(block_num_rows(b)))
        cur = b if carry is None else block_concat([carry, b])
        carry = None
        n = block_num_rows(cur)
        off = 0
        while n - off >= batch_size:
            yield block_to_batch(block_slice(cur, off, off + batch_size),
                                 batch_format)
            off += batch_size
        if off < n:
            carry = block_slice(cur, off, n)
    if carry is not None and block_num_rows(carry) and not drop_last:
        yield block_to_batch(carry, batch_format)


class DataShard:
    """One worker's slice of a dataset: a list of materialized block refs."""

    def __init__(self, refs: List[Any], name: str = "shard"):
        self._refs = list(refs)
        self._name = name

    def __len__(self) -> int:
        return len(self._refs)

    def _blocks(self) -> Iterator[Block]:
        for ref in self._refs:
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        return _iter_batches_from_blocks(self._blocks(), batch_size,
                                         batch_format, drop_last,
                                         local_shuffle_seed)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device=None,
                           drop_last: bool = False,
                           local_shuffle_seed: Optional[int] = None
                           ) -> Iterator[Any]:
        """Train-loop sugar: batches as dicts of torch tensors on
        ``device`` (None: the CUDA card; ref: iterator.py
        iter_torch_batches, whose default is the CPU)."""
        from .block import block_to_torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last,
                                       local_shuffle_seed=local_shuffle_seed):
            yield block_to_torch(batch, dtypes=dtypes, device=device)

    def iter_tf_batches(self, *, batch_size: Optional[int] = 256,
                        dtypes=None, drop_last: bool = False,
                        local_shuffle_seed: Optional[int] = None
                        ) -> Iterator[Any]:
        """Batches as dicts of tf.Tensors in the reference (dataset.py
        iter_tf_batches); the port carries no tensorflow."""
        from .block import missing_package

        raise missing_package("tensorflow", "iter_tf_batches")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for b in self._blocks():
            for row in block_to_rows(b):
                yield row

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self._blocks())

    def materialize_numpy(self) -> Block:
        return block_concat(list(self._blocks()))

    def __repr__(self):
        return f"DataShard({self._name}, {len(self._refs)} blocks)"
