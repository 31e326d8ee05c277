"""SpecLayout — the canonical axis vocabulary for sharded execution
(counterpart of ray_tpu/parallel/sharding/layout.py, copied with its names
and specs; the specs are the port's ``PartitionSpec``).

Every sharded program in the framework speaks three mesh axes:

- ``data``  — batch parallelism (replicated params, sharded batch);
- ``fsdp``  — data parallelism with *sharded* params/opt-state
  (ZeRO-3 style: storage scales 1/fsdp, compute gathers);
- ``tp``    — tensor (megatron) parallelism: attention heads, FFN
  hidden, and the vocab dimension split across chips so a single
  program spans the mesh.

``SpecLayout`` turns that vocabulary into canonical PartitionSpecs per
*parameter family*. The family methods are the single source of
truth for how each kind of tensor shards; model code never spells a
raw ``PartitionSpec``. Models bridge in through their existing
``logical_axes()`` tables via :meth:`spec_for_logical`, so the same
annotations that drove the pure-dp paths now drive tp/fsdp lowering.

A spec may name axes the actual mesh doesn't have (a serve-tp mesh has
no ``fsdp`` axis); :class:`MeshOwner` prunes absent axes to replication
at ``NamedSharding`` time, so one layout serves every mesh shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..mesh import PartitionSpec as P

Axis = str

#: logical axis name (models' ``logical_axes()``) -> SpecLayout axis
#: vocabulary. ``batch`` spreads over data+fsdp (fsdp acts as extra data
#: parallelism for activations); ``embed`` is the fsdp param-sharding
#: dim; heads/mlp/vocab are the megatron dims.
LOGICAL_TO_AXES: Dict[str, Optional[Tuple[Axis, ...]]] = {
    "batch": ("data", "fsdp"),
    "seq": None,
    "embed": None,          # contraction dim of every projection: keep
    # it whole so tp matmuls never partition the reduction (exactness)
    "heads": ("tp",),
    "kv": ("tp",),
    "mlp": ("tp",),
    "vocab": ("tp",),
    "expert": None,
    "stage": None,
}


@dataclass(frozen=True)
class SpecLayout:
    """Canonical PartitionSpecs per parameter/activation family.

    The default axis names match the framework vocabulary; rebinding
    them (e.g. ``SpecLayout(tp_axis="model")``) retargets every family
    spec at once.
    """

    data_axis: Axis = "data"
    fsdp_axis: Axis = "fsdp"
    tp_axis: Axis = "tp"

    # -- parameter families -------------------------------------------------

    def embeddings(self) -> P:
        """Token/positional embedding tables ``[V, D]``: vocab rows over
        tp (the LM-head matmul then contracts the *un*sharded D — every
        chip computes exact logits for its vocab slice)."""
        return P(self.tp_axis, None)

    def qkv_projection(self) -> P:
        """Attention input projections ``[.., D, H*hd]``: output heads
        over tp; the contraction dim D stays whole."""
        return P(None, None, self.tp_axis)

    def attn_output(self) -> P:
        """Attention output projection ``[.., H*hd, D]``: input heads
        over tp (pairs with qkv — the psum lives here)."""
        return P(None, self.tp_axis, None)

    def ffn_up(self) -> P:
        """FFN up/gate projections ``[.., D, F]``: hidden F over tp."""
        return P(None, None, self.tp_axis)

    def ffn_down(self) -> P:
        """FFN down projection ``[.., F, D]``: hidden F over tp."""
        return P(None, self.tp_axis, None)

    def norm(self) -> P:
        """Norm scales/biases: replicated (tiny, every chip needs all)."""
        return P()

    def bias(self, sharded: bool = False) -> P:
        """Projection biases ``[.., out]``: shard with their matmul's
        output dim when that dim is tp-sharded."""
        return P(None, self.tp_axis) if sharded else P()

    # -- activation / cache families ---------------------------------------

    def activations(self) -> P:
        """``[B, S, D]`` residual-stream activations: batch over
        data(+fsdp), everything else whole."""
        return P((self.data_axis, self.fsdp_axis), None, None)

    def kv_cache_blocks(self) -> P:
        """Paged KV pool ``[L, N, Bs, KH, hd]``: the *block* axis over
        tp — each chip owns 1/tp of the pool's blocks (the serve-tp
        memory win; docs/SHARDING.md). The port's tp engine keeps this
        block accounting on the host but shards the device pool by KV
        head instead, every block on every rank: its forward splits
        attention by heads, and a block split would move KV between
        ranks at every step (``KVHeadLayout`` in tensor_parallel.py)."""
        return P(None, self.tp_axis, None, None, None)

    def flat_params(self) -> P:
        """ZeRO/fsdp flat parameter vector: contiguous chunks over
        fsdp (parallel.sharding.fsdp plane)."""
        return P(self.fsdp_axis)

    def replicated(self) -> P:
        return P()

    # -- logical-axis bridge ------------------------------------------------

    def spec_for_logical(self,
                         logical: Sequence[Optional[str]]) -> P:
        """Map a model's per-param logical-axis tuple (its
        ``logical_axes()`` row) to a PartitionSpec in this layout's
        vocabulary. Unknown logical names replicate.

        The mapping deliberately never shards a contraction dimension
        (``embed``): tp matmuls then split only output/batch dims, so
        each partial program computes bit-exact slices and the only
        cross-chip reduction is the attention-output/FFN-down psum.
        """
        names = {"data": self.data_axis, "fsdp": self.fsdp_axis,
                 "tp": self.tp_axis}
        out = []
        for name in logical:
            axes = LOGICAL_TO_AXES.get(name) if name else None
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(names[axes[0]])
            else:
                out.append(tuple(names[a] for a in axes))
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def param_specs(self, model) -> Dict[str, P]:
        """Per-parameter PartitionSpecs for any model exposing
        ``logical_axes()`` (gpt/llama/mlp/...)."""
        return {name: self.spec_for_logical(axes)
                for name, axes in model.logical_axes().items()}


#: the default layout instance shared framework-wide
DEFAULT_LAYOUT = SpecLayout()


def prune_spec(spec: P, axis_sizes: Dict[str, int]) -> P:
    """Drop spec axes the mesh doesn't carry (absent axis == size-1 ==
    replicated). A canonical family spec can then target any mesh —
    a tp-only serve mesh simply ignores the fsdp entries."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if axis_sizes.get(a, 0) > 1)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            out.append(entry if axis_sizes.get(entry, 0) > 1 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)
