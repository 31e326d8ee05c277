"""MPMD pipeline-parallel training engine on compiled graphs (counterpart
of ray_tpu/train/pipeline_cgraph.py).

The steady-state microbatch loop runs over PRE-ALLOCATED cgraph channels
instead of per-call ``.remote()`` task specs.

Shape ("Scaling Deep Learning Training with MPMD Pipeline Parallelism",
PAPERS.md): each stage actor holds resident forward/backward programs for
its (possibly several, interleaved) model chunks, plus a compiled
per-STEP op schedule loaded into the cgraph executor's iterative mode
(cgraph/executor.py). One ``engine.step(batch)`` then drives a full
interleaved 1F1B round with zero per-microbatch scheduling, leasing, or
GCS traffic:

    driver ──act──▶ [stage 0] ──act──▶ [stage 1] ─ ... ─▶ [stage P-1]
           ──tgt──────────────────────────────────────────▶   │
           ◀──loss─────────────────────────────────────────────┘
           ◀─... grads flow backward over their own channels ...─

Channels are multi-slot rings (``slots=num_microbatches``), so a whole
round's activations stream through one edge without the driver in the
loop; with ``virtual_stages > 1`` actor i hosts global chunks
``i, i+P, ...`` and runs the interleaved schedule
(parallel/pipeline.schedule_interleaved_1f1b).

Weight update ("Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training", PAPERS.md): with ``dp > 1`` replicas of the
pipeline, each stage's dp group applies a ZeRO-sharded update — grads
reduce-scatter over the host collective, each replica updates its 1/dp
parameter shard with 1/dp of the optimizer state, and all-gathers fresh
params (parallel/zero.ZeroUpdater; ``zero_update=False`` falls back to
the replicated allreduce update for A/B).

Sharded storage (``fsdp > 1``, parallel/sharding/fsdp.py): each stage's
chunk params and optimizer moments live 1/fsdp per rank, the forward
gathers them exactly once a step, and the update is shard-local, so the
loss trajectory is bit-identical to fsdp=1's. Where the JAX package's
fsdp axis is chips inside the stage's process, a rank of the port is a
process: an fsdp stage is a gang (parallel/mesh_group.MeshGroup) of the
stage actor, rank 0, and ``fsdp - 1`` peer actors in a gloo process
group. The stage alone runs the forward and backward (on one card a
replicated compute in every peer would only repeat the device work); it
gathers the params onto itself when a step first needs them, and at the
update it hands each peer its chunk of the gradient (one scatter a step),
so the arithmetic stays shard-local. The peers hold shards and moments
only. dp composes outside: the stages' host collective syncs the full
gradient first. That is pp x dp x fsdp, with P * dp * fsdp processes.

The chunk programs are torch autograd programs, where the JAX package
jits a forward that returns a pullback. A forward runs the chunk on leaf
parameters that require grad (and, for a floating input, on
``x.detach().requires_grad_()``) and keeps ``(inputs, out)`` as the
residual; the backward is ``torch.autograd.grad`` of ``out`` with the
incoming cotangent. Chunk 0's input is int tokens: it sends no cotangent
upstream. With ``remat=True`` the forward runs under ``no_grad`` and
keeps only its inputs; the backward recomputes it.

Devices. Each stage runs on ``device`` (a string; None = the CUDA card,
which raises where there is none — pass ``device="cpu"`` there). A stage
moves its chunk params and every incoming activation or cotangent to its
device and sends CPU tensors into the channels: a channel carries bytes,
never a device tensor. The loss goes to the driver as a Python float.

The optimizer — the one interface that differs from the JAX package's.
``tx`` is a picklable factory that builds a ``torch.optim.Optimizer``
over a list of tensors, for example
``functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)``
(the JAX package takes an optax transformation). A stage builds one over
its chunks' parameter leaves in ``parallel.zero.tree_flatten`` order; a
ZeRO replica builds one over its flat f32 shard. The update sets each
leaf's ``.grad`` to the scaled accumulated gradient and calls
``step()``. Optimizer state is the optimizer's ``state_dict()``: its
state tensors go into checkpoints and ``opt_state_bytes``. ``tx=None``
runs forward and backward with no update.

Fault contract matches compiled graphs: a stage-actor death aborts the
engine — ``step()`` raises ``CompiledGraphClosedError`` — and
``shutdown()`` releases every pre-allocated channel segment.

Data feed (``attach_feed`` / ``detach_feed`` / ``feed_stats``,
ray_tpu_torch/data/feed.py): pump actors, one per dp replica, take the
producer role of the ``r{r}:in->c0`` / ``r{r}:in->targets`` rings and write
into them what ``step()`` would have written for the same values; a fed
``step()`` takes no batch and only reads losses and reports, with zero
driver dispatches in steady state.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that brings it: elastic capacity (``enable_elastic`` / ``resize``: the
autoscaler, with the serve control plane in A7). ``reshard_checkpoint``
is here.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

import ray_tpu_torch
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.core.placement_group import (placement_group,
                                                remove_placement_group)

from .._device import resolve_device
from ..exceptions import (CompiledGraphClosedError, CompiledGraphError,
                          DataFeedError, GetTimeoutError)
from ..parallel.mesh_group import MeshWorkerMixin
from ..parallel.pipeline import schedule_interleaved_1f1b
from ..parallel.zero import (host_state_dict, optimizer_state_bytes,
                             tree_bytes, tree_flatten, tree_map,
                             tree_unflatten)
from ..perf.recorder import get_recorder as _get_recorder
from ..util import metrics as _metrics
from ..util import tracing

_FLREC = _get_recorder()

_H_STEP = _metrics.Histogram(
    "ray_tpu_pipeline_step_seconds",
    "pipeline-engine full step() latency as observed by the driver",
    boundaries=_metrics.DEFAULT_BOUNDARIES, tag_keys=("engine",))

DEFAULT_CHANNEL_BYTES = 1 << 20
# how long a stage waits for one of its fsdp peers to finish its part of
# a gang operation (the gang's collectives themselves time out with the
# process group, after mesh_group's 300 s)
_GANG_TIMEOUT_S = 300.0


def _host(tree):
    """Every tensor of ``tree`` as a CPU tensor (what the object store
    and the channels carry)."""
    return tree_map(lambda t: t.detach().cpu()
                    if isinstance(t, torch.Tensor) else t, tree)


def _to(tree, device: torch.device):
    """Every tensor (or numpy array) of ``tree`` on ``device``."""
    def move(t):
        if isinstance(t, torch.Tensor):
            return t.to(device)
        if hasattr(t, "__array__") and not isinstance(t, (int, float)):
            return torch.as_tensor(t).to(device)
        return t
    return tree_map(move, tree)


def channel_bytes_by_edge() -> Dict[str, int]:
    """{edge: envelope bytes this process has written to compiled-graph
    channels} (``ray_tpu_cgraph_channel_bytes_total`` summed over its
    codec tag). Edge names are the engine's (``r0:c0->c1``, ...): the
    driver writes the ``in`` edges, each stage its outputs."""
    from ..cgraph.channel import _C_CHAN_BYTES

    out: Dict[str, int] = {}
    with _C_CHAN_BYTES._lock:
        for (edge, _codec), v in _C_CHAN_BYTES._values.items():
            out[edge] = out.get(edge, 0) + int(v)
    return out


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# resident chunk programs — shared by the stage actor AND the
# single-process reference (run_reference_1f1b), so the engine's loss
# trajectory can be compared bit-for-bit against the reference
# ---------------------------------------------------------------------------


def _make_programs(fn: Callable, has_targets: bool, remat: bool):
    """(fwd, bwd) autograd programs for one model chunk.

    remat=False: ``fwd(p, x[, tgt])`` returns ``(out, residual)`` — the
    residual holds the leaf inputs and the output of the recorded graph
    (the 1F1B in-flight activation memory); ``bwd(residual, g)`` pulls
    ``g`` back through it. remat=True: ``fwd`` runs under ``no_grad`` and
    returns only ``out``; ``bwd(p, x[, tgt], g)`` re-runs the forward
    with grad and pulls back through it (activation rematerialization —
    ~1/3 more FLOPs, O(inputs) residual memory).

    Both backwards return ``(param_grads, x_grad)``: the gradient tree in
    the params' structure (zeros for an unused leaf) and the input's
    cotangent (None for a non-floating input).
    """
    def run(p, x, tgt):
        leaves, treedef = tree_flatten(p)
        leaves = [t.detach().requires_grad_() for t in leaves]
        xx = x.detach().requires_grad_() if x.is_floating_point() else x
        pp = tree_unflatten(treedef, leaves)
        with torch.enable_grad():
            out = fn(pp, xx, tgt) if has_targets else fn(pp, xx)
        return out, (leaves, treedef, xx, out)

    def pull(res, g):
        leaves, treedef, xx, out = res
        wrt = ([xx] if xx.requires_grad else []) + leaves
        grads = torch.autograd.grad(out, wrt, g, allow_unused=True)
        grads = [torch.zeros_like(w) if gr is None else gr
                 for w, gr in zip(wrt, grads)]
        gx = grads[0] if xx.requires_grad else None
        return tree_unflatten(treedef, grads[len(wrt) - len(leaves):]), gx

    if not remat:
        def fwd(p, x, tgt=None):
            out, res = run(p, x, tgt)
            return out.detach(), res

        return fwd, pull

    def fwd_remat(p, x, tgt=None):
        with torch.no_grad():
            return fn(p, x, tgt) if has_targets else fn(p, x)

    if has_targets:
        def bwd_remat(p, x, tgt, g):
            return pull(run(p, x, tgt)[1], g)
    else:
        def bwd_remat(p, x, g):
            return pull(run(p, x, None)[1], g)
    return fwd_remat, bwd_remat


def _seed(device: torch.device) -> torch.Tensor:
    """The loss's cotangent: an f32 1.0, as the JAX package seeds it."""
    return torch.ones((), dtype=torch.float32, device=device)


def _set_grads(leaves: List[torch.Tensor], grads: List[torch.Tensor]):
    for leaf, g in zip(leaves, grads):
        leaf.grad = g


def _opt_step(opt: torch.optim.Optimizer, leaves: List[torch.Tensor],
              grads) -> None:
    """One optimizer step with ``grads`` (a tree in the leaves' order)."""
    _set_grads(leaves, tree_flatten(grads)[0])
    opt.step()
    _set_grads(leaves, [None] * len(leaves))


def run_reference_1f1b(stage_fns: Sequence[Callable],
                       stage_params: Sequence[Any],
                       tx,
                       steps: Sequence[Tuple[Sequence[Any], Sequence[Any]]],
                       remat: bool = False,
                       tied: Sequence[tuple] = (),
                       device: Optional[str] = None):
    """Single-process reference executing the SAME chunk programs in the
    same order/arithmetic as the compiled engine (dp=1): fwd per
    microbatch ascending, bwd per microbatch ascending, grads
    accumulated in arrival order, tied grads exchanged once, update
    scaled by 1/M. Runs on ``device`` (None = the CUDA card) on copies of
    ``stage_params``. Returns ``(losses_per_step, final_stage_params)``
    — the engine's trajectory must match this bit-for-bit at a fixed
    seed."""
    dev = resolve_device(device)
    G = len(stage_fns)
    progs = [_make_programs(fn, g == G - 1, remat)
             for g, fn in enumerate(stage_fns)]
    params = [tree_map(lambda t: t.detach().to(dev, copy=True), p)
              for p in stage_params]
    leaves = [tree_flatten(p)[0] for p in params]
    opts = [tx(lv) for lv in leaves] if tx is not None else None
    losses_out: List[float] = []
    for mbs, tgts in steps:
        M = len(mbs)
        acc: List[Any] = [None] * G
        residuals: Dict[Tuple[int, int], Any] = {}
        step_losses = []
        for m in range(M):
            x = _to(mbs[m], dev)
            tgt = _to(tgts[m], dev)
            for g in range(G):
                fwd, _ = progs[g]
                if g == G - 1:
                    if remat:
                        out = fwd(params[g], x, tgt)
                        residuals[(g, m)] = (x, tgt)
                    else:
                        out, res = fwd(params[g], x, tgt)
                        residuals[(g, m)] = res
                else:
                    if remat:
                        out = fwd(params[g], x)
                        residuals[(g, m)] = (x,)
                    else:
                        out, res = fwd(params[g], x)
                        residuals[(g, m)] = res
                x = out
            step_losses.append(float(out))
        for m in range(M):
            cot = _seed(dev)
            for g in reversed(range(G)):
                _, bwd = progs[g]
                res = residuals.pop((g, m))
                if remat:
                    gp, gx = bwd(params[g], *res, cot)
                else:
                    gp, gx = bwd(res, cot)
                acc[g] = gp if acc[g] is None else tree_map(
                    lambda a, b: a + b, acc[g], gp)
                cot = gx
        for (gi, ki, gj, kj) in tied:
            a, b = acc[gi][ki], acc[gj][kj]
            acc[gi][ki] = a + b
            acc[gj][kj] = b + a
        scale = 1.0 / M
        if opts is not None:
            for g in range(G):
                _opt_step(opts[g], leaves[g],
                          tree_map(lambda t: t * scale, acc[g]))
        losses_out.append(float(sum(step_losses) / M))
    return losses_out, params


# ---------------------------------------------------------------------------
# resharding — checkpoints move across dp widths bit-exactly
# ---------------------------------------------------------------------------


def reshard_checkpoint(ckpt: dict, dp: int) -> dict:
    """Re-shard a checkpoint payload (``save_checkpoint`` /
    ``_pull_state_grid`` shape) to a new dp width.

    Parameters are identical across dp rows by construction (the update
    all-gathers/replicates them), so row 0's copy seeds every new row.
    Optimizer state moves by kind:

    - ``full`` (replicated ``state_dict``) / ``fsdp`` (each chunk's
      state over its whole padded flat vector, identical across dp rows)
      / ``none``: row 0 replicates to every new row, so dp resizes around
      the fsdp plane; growing a ``full``-kind state under a
      ``zero_update`` engine converts it to flat ZeRO shards
      (:func:`parallel.zero.flatten_opt_state`).
    - ``zero``: per-rank flat shards merge in rank order and re-split
      across the new width (pure byte movement — bit-exact); shrinking
      to dp=1 converts back to the replicated tree plane.

    ``num_microbatches`` rescales so the GLOBAL batch (dp * M
    microbatches per step) is invariant: the resharded trajectory is the
    same arithmetic a fixed-size run at the new width would execute.
    """
    from ..parallel.zero import (flatten_opt_state, flatten_tree,
                                 merge_opt_shards, split_opt_state,
                                 unflatten_opt_state)

    meta = dict(ckpt["engine"])
    old_dp = int(meta["dp"])
    new_dp = int(dp)
    if new_dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    total_mb = int(meta["num_microbatches"]) * old_dp
    if total_mb % new_dp:
        raise ValueError(
            f"global batch of {total_mb} microbatches does not divide "
            f"across dp={new_dp}; valid widths divide {total_mb}")
    states = ckpt["states"]
    P = len(states[0])
    zero_update = bool(meta.get("zero_update", True))
    new_rows: List[List[dict]] = [[None] * P for _ in range(new_dp)]
    for i in range(P):
        row0 = states[0][i]
        kind = row0.get("kind", "none")
        params = row0["params"]
        params_dict = {str(v): params[v] for v in range(len(params))}
        if kind == "zero":
            shards = [states[r][i]["opt"] for r in range(old_dp)]
            flat, spec = flatten_tree(params_dict)
            merged = merge_opt_shards(shards)
            if new_dp == 1:
                # grad_codec updaters wrap their state as {"tx",
                # "master"}; dp=1 has no dp wire, so the master copy is
                # dropped and the bare optimizer state unflattens
                if isinstance(merged, dict) \
                        and set(merged) == {"tx", "master"}:
                    merged = merged["tx"]
                opts = [unflatten_opt_state(merged, spec)]
                new_kind = "full"
            else:
                opts = split_opt_state(merged, new_dp, spec.size)
                new_kind = "zero"
        elif kind == "full" and new_dp > 1 and zero_update:
            flat, spec = flatten_tree(params_dict)
            opts = split_opt_state(
                flatten_opt_state(row0["opt"], params_dict),
                new_dp, spec.size)
            new_kind = "zero"
        else:
            # none / fsdp / replicated-full: dp rows are identical copies
            opts = [row0["opt"]] * new_dp
            new_kind = kind
        for r in range(new_dp):
            new_rows[r][i] = {"params": params, "opt": opts[r],
                              "kind": new_kind}
    meta["dp"] = new_dp
    meta["num_microbatches"] = total_mb // new_dp
    return {"step": int(ckpt.get("step", 0)), "engine": meta,
            "states": new_rows}


# ---------------------------------------------------------------------------
# the stage actor
# ---------------------------------------------------------------------------


def _kernel_launches() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process since it
    started."""
    from ..ops import (flash_attention_bwd, flash_attention_fwd,
                       ln_matmul_fwd, matmul_residual_fwd)

    return {f.__name__: f.launches for f in (
        flash_attention_fwd, flash_attention_bwd, ln_matmul_fwd,
        matmul_residual_fwd)}


class _FsdpRank(MeshWorkerMixin):
    """What every rank of an fsdp stage's gang runs: the stage actor (rank
    0, which alone holds gradients and full params) and its peers alike.
    Each ``fsdp_*`` method is collective: the stage runs it on every rank
    of its gang, in the same order (``_CGStage._on_gang``), passing the
    data that rank 0 alone has; the peers pass None."""

    def _fsdp_init(self, virtual: int, tx, device: torch.device, name: str,
                   chunk_params: Optional[List[Any]] = None) -> None:
        import torch.distributed as dist

        from ..parallel.sharding import FsdpPlane, MeshOwner

        owner = MeshOwner.fsdp_mesh(dist.get_world_size(),
                                    device_type=device.type, name=name)
        self._plane = FsdpPlane(owner, tx)
        self._fsdp_state: Dict[str, Any] = {}
        self._fsdp_opt: Dict[str, Any] = {}
        for v in range(virtual):
            key = str(v)
            self._fsdp_state[key] = self._plane.shard(
                None if chunk_params is None else chunk_params[v], src=0)
            if tx is not None:
                self._fsdp_opt[key] = self._plane.init_opt(
                    self._fsdp_state[key])

    def fsdp_gather(self, v: int):
        """Chunk ``v``'s full params on rank 0 (None elsewhere)."""
        return self._plane.gather(self._fsdp_state[str(v)], dst=0)

    def fsdp_update(self, v: int, grads=None) -> bool:
        """Chunk ``v``'s sharded step: rank 0 scatters the chunks of its
        full ``grads``, each rank steps its shard."""
        key = str(v)
        self._fsdp_state[key], self._fsdp_opt[key] = self._plane.update(
            self._fsdp_state[key], grads, self._fsdp_opt[key], src=0)
        return True

    def fsdp_accounting(self) -> Tuple[Dict[int, int], int]:
        """({rank: resident param + moment bytes}, optimizer bytes over the
        gang), summed over the hosted chunks."""
        per_rank: Dict[int, int] = {}
        opt_bytes = 0
        for key in sorted(self._fsdp_state, key=int):
            fp, opt = self._fsdp_state[key], self._fsdp_opt.get(key)
            for rank, b in self._plane.per_device_bytes(fp, opt).items():
                per_rank[rank] = per_rank.get(rank, 0) + b
            if opt is not None:
                opt_bytes += self._plane.opt_state_bytes(opt)
        return per_rank, opt_bytes

    def fsdp_to_host(self, v: int):
        """Chunk ``v``'s checkpoint payload (full params, merged optimizer
        state) on rank 0."""
        key = str(v)
        return self._plane.to_host(self._fsdp_state[key],
                                   self._fsdp_opt.get(key), dst=0)

    def fsdp_load(self, v: int, has_params: bool, has_opt: bool,
                  params=None, opt=None) -> bool:
        """Restore chunk ``v`` from rank 0's payload: new params are copied
        into the shard in place (its optimizer stays bound to it), an
        optimizer state replaces the moments."""
        key = str(v)
        fp = self._fsdp_state[key]
        if has_params:
            with torch.no_grad():
                fp.flat.copy_(self._plane.shard(params, src=0).flat)
        if has_opt:
            self._fsdp_opt[key] = self._plane.place_opt(fp, opt, src=0)
        return True

    def fsdp_rank_info(self) -> dict:
        """This rank's pid and device, its CUDA bytes held and peak, the
        bytes of its shards and moments and the devices they lie on, and
        its kernel launches since the process started."""
        dev = self._plane.device
        cuda = dev.type == "cuda"
        tensors = [fp.flat for fp in self._fsdp_state.values()] + [
            t for opt in self._fsdp_opt.values()
            for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor) and t.ndim >= 1]
        return {"pid": os.getpid(), "device": str(dev),
                "memory_allocated": int(
                    torch.cuda.memory_allocated() if cuda else 0),
                "max_memory_allocated": int(
                    torch.cuda.max_memory_allocated() if cuda else 0),
                "shard_bytes": sum(fp.flat.numel() * fp.flat.element_size()
                                   for fp in self._fsdp_state.values()),
                "opt_bytes": sum(optimizer_state_bytes(o)
                                 for o in self._fsdp_opt.values()),
                "tensor_devices": sorted({str(t.device) for t in tensors}),
                "kernel_launches": _kernel_launches()}


class _FsdpPeer(_FsdpRank):
    """A rank of an fsdp stage's gang other than the stage actor: it holds
    its shards of the stage's chunk params and their moments, and runs
    the gang operations the stage asks for."""

    def fsdp_setup(self, virtual: int, tx_blob: Optional[bytes],
                   device: Optional[str], name: str) -> bool:
        self.device = resolve_device(device)
        tx = cloudpickle.loads(tx_blob) if tx_blob else None
        self._fsdp_init(virtual, tx, self.device, name)
        return True


class _CGStage(_FsdpRank):
    """One pipeline stage actor: hosts ``virtual`` model chunks with
    resident fwd/bwd programs, accumulates grads per chunk, and applies
    the (optionally ZeRO-sharded) optimizer update. Its methods are never
    called per-microbatch over the task plane — the cgraph executor's
    iterative loop drives them from the compiled schedule. With
    ``fsdp > 1`` it is rank 0 of its gang (module docstring)."""

    def setup(self, actor_idx: int, num_actors: int, virtual: int,
              fn_blobs: List[bytes], chunk_params: List[Any],
              chunk_meta: List[dict], tx_blob: Optional[bytes],
              remat: bool, dp: int, dp_rank: int,
              group_name: str, zero_update: bool,
              grad_codec: Optional[str] = None,
              device: Optional[str] = None, fsdp: int = 1,
              peers: Sequence[Any] = ()) -> bool:
        self.idx = actor_idx
        self.num_actors = num_actors
        self.virtual = virtual
        self.meta = chunk_meta
        self.dp = dp
        self.dp_rank = dp_rank
        self.fsdp = int(fsdp)
        self.zero_update = zero_update
        self.group_name = group_name
        # dp-sync wire codec: block-scaled quantized collectives on every
        # grad-sync leg; None = fp32
        self.grad_codec = grad_codec
        self.device = resolve_device(device)
        fns = [cloudpickle.loads(b) for b in fn_blobs]
        self._progs = [
            _make_programs(fns[v], chunk_meta[v]["last"], remat)
            for v in range(virtual)]
        self._remat = remat
        self._residuals: Dict[Tuple[int, int], Any] = {}
        self._grad_acc: Dict[str, Any] = {}
        self.tx = cloudpickle.loads(tx_blob) if tx_blob else None
        self._zero = None
        self._opt = None
        self._plane = None
        self._peers = list(peers)
        self._param_cache: Dict[str, Any] = {}
        self._gather_s = 0.0
        if self.fsdp > 1:
            # the sharded storage: this rank's 1/fsdp of each chunk's
            # params and moments, the rest on the peers; the forward
            # gathers, the update is shard-local
            refs = [p.fsdp_setup.remote(virtual, tx_blob, device,
                                        self._gang_name())
                    for p in self._peers]
            self._fsdp_init(virtual, self.tx, self.device, self._gang_name(),
                            chunk_params)
            ray_tpu_torch.get(refs, timeout=_GANG_TIMEOUT_S)
            self.params = {}
        else:
            self.params = {str(v): _to(chunk_params[v], self.device)
                           for v in range(virtual)}
        self._leaves = tree_flatten(self.params)[0]
        if self.tx is not None:
            if dp > 1:
                from ..parallel import collective

                # the group lives for the engine run; released by
                # _destroy_collective_groups at shutdown/recover
                collective.create_collective_group(
                    dp, dp_rank, group_name=group_name)
            if self._plane is not None:
                # fsdp composes with dp through the host collective's
                # gradient sync (update() allreduces the mean before the
                # sharded step); the moments were made with the shards
                pass
            elif dp > 1 and zero_update:
                from ..parallel.zero import ZeroUpdater

                self._zero = ZeroUpdater(
                    self.tx, dp, dp_rank, group_name=group_name,
                    grad_codec=grad_codec).init(self.params)
            else:
                self._opt = self.tx(self._leaves)
        return True

    def _gang_name(self) -> str:
        return f"stage{self.idx}-r{self.dp_rank}"

    def _on_gang(self, method: str, *args, **rank0_kwargs):
        """Run the collective ``method(*args)`` on every rank of this
        stage's fsdp gang: the peers' actor calls go out first, then this
        rank's call, given ``rank0_kwargs`` as well (the data only rank 0
        holds); each peer is waited for at most _GANG_TIMEOUT_S. Returns
        this rank's result."""
        refs = [getattr(p, method).remote(*args) for p in self._peers]
        out = getattr(self, method)(*args, **rank0_kwargs)
        ray_tpu_torch.get(refs, timeout=_GANG_TIMEOUT_S)
        return out

    def _params_of(self, v: int):
        """Chunk ``v``'s full parameter tree. fsdp: gathered from the
        shards when the step first needs it, cached for the step (update()
        drops the cache, so only shards persist between steps)."""
        key = str(v)
        if self._plane is None:
            return self.params[key]
        cached = self._param_cache.get(key)
        if cached is None:
            t0 = time.perf_counter()
            cached = self._param_cache[key] = self._on_gang("fsdp_gather", v)
            # the gather's wall time, drained into the step report
            self._gather_s += time.perf_counter() - t0
        return cached

    # -- schedule ops (driven by the cgraph iterative loop) ---------------

    def forward(self, v: int, mb: int, x, targets=None):
        """Chunk ``v``'s microbatch forward. Returns the activation for
        the next chunk (a CPU tensor) — or, on the LAST global chunk, the
        scalar loss as a float (which the schedule routes to the driver's
        loss channel)."""
        fwd, _ = self._progs[v]
        p = self._params_of(v)
        x = _to(x, self.device)
        if self.meta[v]["last"]:
            targets = _to(targets, self.device)
            if self._remat:
                out = fwd(p, x, targets)
                self._residuals[(v, mb)] = (x, targets)
            else:
                out, res = fwd(p, x, targets)
                self._residuals[(v, mb)] = res
            return float(out)
        if self._remat:
            out = fwd(p, x)
            self._residuals[(v, mb)] = (x,)
        else:
            out, res = fwd(p, x)
            self._residuals[(v, mb)] = res
        return out.cpu()

    def backward(self, v: int, mb: int, g=None):
        """Chunk ``v``'s microbatch backward: consumes the saved
        residual, accumulates this chunk's param grads, and returns the
        cotangent for the upstream chunk (a CPU tensor; None on chunk 0,
        whose input is tokens). The last global chunk gets no ``g``: the
        loss pulls back from 1.0."""
        _, bwd = self._progs[v]
        res = self._residuals.pop((v, mb))
        if g is None:
            g = _seed(self.device)
        else:
            g = _to(g, self.device)
        if self._remat:
            gp, gx = bwd(self._params_of(v), *res, g)
        else:
            gp, gx = bwd(res, g)
        key = str(v)
        if self._grad_acc.get(key) is None:
            self._grad_acc[key] = gp
        else:
            self._grad_acc[key] = tree_map(
                lambda a, b: a + b, self._grad_acc[key], gp)
        return None if gx is None else gx.cpu()

    def tied_grad(self, v: int, key: str):
        """Ship this chunk's accumulated grad for a tied weight to the
        partner chunk (Megatron-style tied-embedding exchange)."""
        return self._grad_acc[str(v)][key].cpu()

    def tied_add(self, v: int, key: str, g) -> bool:
        self._grad_acc[str(v)][key] = self._grad_acc[str(v)][key] \
            + _to(g, self.device)
        return True

    def update(self, scale: float) -> dict:
        """End-of-step optimizer update over every hosted chunk. With a
        dp group: ZeRO reduce-scatter/shard-update/all-gather (or the
        replicated allreduce update when zero_update=False). With fsdp:
        the dp sync first, then the sharded step on the gang. Returns the
        stage report shipped to the driver."""
        t0 = time.perf_counter()
        grads = {k: tree_map(lambda t: t * scale, v)
                 for k, v in self._grad_acc.items()}
        sync = {"rs_ms": 0.0, "ag_ms": 0.0, "allreduce_ms": 0.0,
                "gather_ms": round(self._gather_s * 1e3, 3)}
        self._gather_s = 0.0
        if self.tx is None:
            self._param_cache = {}  # evaluation engine: grads dropped
        elif self._plane is not None:
            # fsdp: dp-sync the full grads first (host allreduce mean, the
            # replicated path's arithmetic), then each chunk's sharded
            # step; the gathered params drop, so only 1/fsdp persists
            if self.dp > 1:
                from ..parallel import collective
                from ..parallel.zero import flatten_tree, unflatten_tree

                flat_g, spec = flatten_tree(grads)
                t_ar = time.perf_counter()
                mean = collective.allreduce(
                    flat_g.cpu(), self.group_name,
                    codec=self.grad_codec) / self.dp
                sync["allreduce_ms"] = round(
                    (time.perf_counter() - t_ar) * 1e3, 3)
                grads = unflatten_tree(
                    mean.to(device=self.device, dtype=spec.dtype), spec)
            for v in range(self.virtual):
                self._on_gang("fsdp_update", v, grads=grads[str(v)])
            self._param_cache = {}
        elif self._zero is not None:
            self.params = self._zero.update(self.params, grads)
            self._leaves = tree_flatten(self.params)[0]
            sync["rs_ms"] = round(self._zero.last_rs_s * 1e3, 3)
            sync["ag_ms"] = round(self._zero.last_ag_s * 1e3, 3)
        elif self.dp > 1:
            # replicated A/B path: allreduce-mean over the flat vector,
            # full-tree update on every replica (full opt state each)
            from ..parallel import collective
            from ..parallel.zero import flatten_tree, unflatten_tree

            flat_g, spec = flatten_tree(grads)
            t_ar = time.perf_counter()
            mean = collective.allreduce(
                flat_g.cpu(), self.group_name,
                codec=self.grad_codec) / self.dp
            sync["allreduce_ms"] = round(
                (time.perf_counter() - t_ar) * 1e3, 3)
            _opt_step(self._opt, self._leaves, unflatten_tree(
                mean.to(device=self.device, dtype=spec.dtype), spec))
        else:
            _opt_step(self._opt, self._leaves, grads)
        self._grad_acc = {}
        if self.device.type == "cuda":
            # the step's device work ends inside this op, so update_ms
            # and the next step's spans hold no leftover of this one
            torch.cuda.synchronize(self.device)
        update_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if self._plane is not None:
            per_rank, opt_bytes = self._on_gang("fsdp_accounting")
        else:
            opt_bytes = self.opt_state_bytes()
        report = {
            "stage": self.idx, "dp_rank": self.dp_rank,
            "update_ms": update_ms,
            "opt_state_bytes": opt_bytes,
            "in_flight_residuals": len(self._residuals),
            # collective sync-exposed ms: ZeRO reduce-scatter/all-gather
            # legs, dp allreduce, fsdp gather
            "sync_ms": round(sum(sync.values()), 3),
            "sync_breakdown": sync,
        }
        if self._plane is not None:
            # each rank's resident params + moments between steps: the
            # ~1/fsdp acceptance number
            report["fsdp"] = self.fsdp
            report["fsdp_bytes_per_chip"] = {
                str(r): b for r, b in sorted(per_rank.items())}
        # per-op wall spans + cumulative exec/bubble recorded by the
        # cgraph executor in THIS process (perf/oplog.py); update() is
        # the last op of the step schedule on the same thread, so the
        # drain rides the existing report channel to the driver
        from ..perf import oplog as _oplog

        report["perf"] = _oplog.stage_perf(f"{self.dp_rank}.{self.idx}")
        return report

    # -- dynamic-path surface (driver calls between steps) ----------------

    def get_params(self) -> List[Any]:
        if self._plane is not None:
            # a transient gather, NOT through the step cache: a between-
            # steps inspection must not leave full params resident
            return [_host(self._on_gang("fsdp_gather", v))
                    for v in range(self.virtual)]
        return [_host(self.params[str(v)]) for v in range(self.virtual)]

    def get_state(self) -> dict:
        """Checkpoint payload for this actor: hosted chunk params plus
        the optimizer state it owns — the full ``state_dict`` when
        replicated, the 1/dp SHARD when ZeRO-sharded (each dp rank
        persists its own shard; restore hands each rank its shard back).
        CPU copies, pulled by the driver BETWEEN steps, when no residuals
        are in flight. fsdp: the full params and each chunk's optimizer
        state over its whole padded flat vector, kind "fsdp" (restore
        re-shards both onto the same fsdp width, which the engine's
        geometry check enforces)."""
        if self._plane is not None:
            params, opt = [], {}
            for v in range(self.virtual):
                p, o = self._on_gang("fsdp_to_host", v)
                params.append(p)
                if o is not None:
                    opt[str(v)] = o
            return {"params": params, "opt": opt or None, "kind": "fsdp"}
        if self._zero is not None:
            opt, kind = self._zero.opt_state(), "zero"
        elif self._opt is not None:
            opt, kind = host_state_dict(self._opt), "full"
        else:
            opt, kind = None, "none"
        return {"params": [tree_map(
                    lambda t: t.detach().to("cpu", copy=True),
                    self.params[str(v)]) for v in range(self.virtual)],
                "opt": opt, "kind": kind}

    def load_state(self, chunk_params: Optional[List[Any]], opt_state,
                   kind: str) -> bool:
        """Restore a get_state() payload: params are copied into the
        hosted chunks (None = keep what setup() installed — the recover
        path ships checkpoint params through setup already and must not
        pay the serialization twice), optimizer state replaces what
        setup() initialized, and any in-flight residual/grad accumulation
        is discarded (restore happens at a step boundary by
        construction)."""
        if chunk_params is not None and self._plane is not None:
            for v in range(self.virtual):
                self._on_gang("fsdp_load", v, True, False,
                              params=chunk_params[v])
        elif chunk_params is not None:
            new = [tree_flatten(_to(chunk_params[v], self.device))[0]
                   for v in range(self.virtual)]
            with torch.no_grad():
                for leaf, src in zip(self._leaves,
                                     [t for lv in new for t in lv]):
                    leaf.copy_(src)
        self._residuals = {}
        self._grad_acc = {}
        self._param_cache = {}
        if kind == "fsdp":
            if self._plane is None:
                raise ValueError(
                    "checkpoint holds fsdp-sharded state but this stage "
                    "runs unsharded (fsdp flag changed between save and "
                    "restore)")
            if opt_state is not None:
                for v in range(self.virtual):
                    self._on_gang("fsdp_load", v, False, True,
                                  opt=opt_state[str(v)])
        elif kind == "zero":
            if self._zero is None:
                raise ValueError(
                    "checkpoint holds a ZeRO opt-state shard but this "
                    "stage runs a replicated update (zero_update flag "
                    "changed between save and restore)")
            self._zero.set_opt_state(opt_state)
        elif kind == "full":
            if self._opt is None:
                raise ValueError(
                    "checkpoint holds a replicated opt state but this "
                    "stage is ZeRO-sharded or has no optimizer")
            self._opt.load_state_dict(opt_state)
        return True

    def opt_state_bytes(self) -> int:
        if self._plane is not None:
            return self._on_gang("fsdp_accounting")[1]
        if self._zero is not None:
            return self._zero.opt_state_bytes()
        return optimizer_state_bytes(self._opt) \
            if self._opt is not None else 0

    def placement(self) -> dict:
        """This stage's worker pid, device, device bytes held and peak,
        parameter bytes, and since the process started: hand-written
        kernel launches and the bytes it wrote to each channel edge. fsdp:
        the bytes of this rank's shards, and ``fsdp_ranks``, each gang
        rank's ``fsdp_rank_info()`` in rank order."""
        cuda = self.device.type == "cuda"
        out = {"pid": os.getpid(), "device": str(self.device),
               "memory_allocated": int(
                   torch.cuda.memory_allocated(self.device) if cuda else 0),
               "max_memory_allocated": int(
                   torch.cuda.max_memory_allocated(self.device)
                   if cuda else 0),
               "param_bytes": tree_bytes(self.params),
               "kernel_launches": _kernel_launches(),
               "channel_bytes": channel_bytes_by_edge()}
        if self._plane is not None:
            out["param_bytes"] = tree_bytes(
                [fp.flat for fp in self._fsdp_state.values()])
            out["fsdp_ranks"] = [self.fsdp_rank_info()] + ray_tpu_torch.get(
                [p.fsdp_rank_info.remote() for p in self._peers],
                timeout=_GANG_TIMEOUT_S)
        return out

    def cleanup(self) -> bool:
        """Tear down this stage's dp collective group (rank 0 kills the
        rendezvous store so nothing detached outlives the engine)."""
        if self.dp > 1 and self.dp_rank == 0:
            from ..parallel import collective

            collective.destroy_collective_group(self.group_name)
        return True


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class _StagePlan:
    __slots__ = ("actor_id", "node", "worker", "handle", "in_specs",
                 "nodes", "stage", "replica", "_report_w")

    def __init__(self, actor_id, node, worker, handle, stage, replica):
        self.actor_id = actor_id
        self.node = node
        self.worker = worker
        self.handle = handle
        self.stage = stage
        self.replica = replica
        self.in_specs: List[dict] = []
        self.nodes: List[dict] = []
        self._report_w = None


class CompiledPipelineEngine:
    """Drives ``dp`` replicas x ``P`` stage actors through interleaved
    1F1B over pre-allocated cgraph channels.

    stage_fns: G = P * virtual_stages chunk callables in global order.
        Chunks 0..G-2: ``fn(params, x) -> activation``; the last chunk:
        ``fn(params, x, targets) -> scalar loss`` (G == 1 collapses both
        into the last-chunk signature — a pure-dp engine).
    stage_params: G parameter trees (one per chunk; tensors on any
        device — the engine ships CPU copies).
    tx: optimizer factory over a list of tensors (None = forward/backward
        only, no update); see the module docstring.
    num_microbatches: 1F1B round size M; ``step()`` takes dp*M
        microbatches (contiguous M-slices per dp replica).
    virtual_stages: model chunks per actor (interleaved 1F1B when > 1).
    dp: data-parallel pipeline replicas; each stage's dp group syncs
        grads at update time.
    fsdp: sharded param/opt-state axis of each stage
        (parallel.sharding.FsdpPlane over a gang of the stage actor and
        ``fsdp - 1`` peer actors in a gloo group; module docstring): chunk
        params and optimizer moments live 1/fsdp per rank, the forward
        gathers them exactly, the update is shard-local — the loss
        trajectory is bit-identical to fsdp=1's. Composes with dp (host
        gradient sync) and the pipeline stages into pp x dp x fsdp, in
        P * dp * fsdp processes (and placement bundles).
    zero_update: ZeRO-shard the dp update (1/dp optimizer state per
        replica) vs the replicated allreduce update (fsdp=1; with fsdp > 1
        the sharded update runs on the fsdp plane instead).
    grad_codec: block-scaled wire codec ("int8"/"e4m3") for the dp
        gradient sync — the ZeRO reduce-scatter/all-gather (fp32 master
        shards) or the replicated allreduce ship quantized payloads, ~1/4
        the bytes over the dp wire; None (default) = full precision.
    wire_codec: same codec vocabulary applied to the cgraph CHANNEL
        payloads — pipeline activations and cotangents cross their hops
        block-quantized (large float tensors only; small/non-float
        payloads like losses and reports pass through raw). Lossy by
        construction; seq/error-envelope semantics are unchanged.
    remat: recompute chunk forwards in the backward instead of holding
        autograd residuals (activation rematerialization knob).
    tied: [(chunk_i, key_i, chunk_j, key_j), ...] tied-weight pairs
        whose grads are exchanged and summed before each update.
    channel_bytes: capacity of one slot of every channel; a value over it
        raises ``ChannelFullError`` from ``step()``.
    checkpoint_dir: non-empty => the engine can persist per-stage params
        + optimizer state (ZeRO shards stay sharded) to this directory
        with atomic rename-commit; with checkpoint_every > 0 a snapshot
        is pulled off the actors after every Nth step and written on a
        background thread (the pull is synchronous — between steps — so
        the snapshot is a consistent step boundary; only the disk IO is
        async). ``recover()`` restores from the newest commit, and the
        restored trajectory is bit-identical to a clean restart from the
        same checkpoint.
    device: where every stage runs, as a string (None = the CUDA card;
        ``"cpu"`` where there is none).
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any],
                 tx=None, *,
                 num_microbatches: int,
                 virtual_stages: int = 1,
                 dp: int = 1,
                 fsdp: int = 1,
                 zero_update: bool = True,
                 grad_codec: Optional[str] = None,
                 wire_codec: Optional[str] = None,
                 remat: bool = False,
                 tied: Sequence[tuple] = (),
                 channel_bytes: int = DEFAULT_CHANNEL_BYTES,
                 resources_per_stage: Optional[dict] = None,
                 scheduling_strategies: Optional[Sequence] = None,
                 setup_timeout: float = 120.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 device: Optional[str] = None):
        G = len(stage_fns)
        V = int(virtual_stages)
        if G < 1 or len(stage_params) != G:
            raise ValueError("need one param tree per stage fn")
        if V < 1 or G % V:
            raise ValueError(
                f"{G} chunks not divisible into virtual_stages={V}")
        M = int(num_microbatches)
        if M < 1:
            raise ValueError("num_microbatches must be >= 1")
        self.fsdp = int(fsdp)
        if self.fsdp < 1:
            raise ValueError(f"fsdp must be >= 1, got {fsdp}")
        self.num_chunks = G
        self.num_stages = G // V
        self.virtual = V
        self.num_microbatches = M
        self.dp = int(dp)
        self.zero_update = bool(zero_update)
        from ..parallel.quant import check_codec

        self.grad_codec = check_codec(grad_codec)
        self.wire_codec = check_codec(wire_codec)
        self.tied = list(tied)
        self.device = None if device is None else str(device)
        self.graph_id = os.urandom(16)
        self._gtag = self.graph_id.hex()[:8]
        self._channel_bytes = int(channel_bytes)
        self._lock = threading.Lock()
        # serializes the teardown BODY (not just the torn flag): an abort
        # tears down on a background thread, and a concurrent shutdown()
        # must block until the channels are actually released. REENTRANT:
        # a signal handler or close-callback re-entering teardown on the
        # thread already inside it must return (via the torn flag), not
        # self-deadlock.
        self._teardown_lock = threading.RLock()
        self._stop = threading.Event()
        # fault-recovery state: everything needed to respawn stages and
        # recompile channels after a kill
        self._fn_blobs = [cloudpickle.dumps(fn) for fn in stage_fns]
        self._tx_blob = cloudpickle.dumps(tx) if tx is not None else None
        self._init_params = [_host(p) for p in stage_params]
        self._remat = bool(remat)
        self._res = resources_per_stage
        self._strategies = scheduling_strategies
        self._setup_timeout = float(setup_timeout)
        self.checkpoint_dir = checkpoint_dir or None
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_dir:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._step_count = 0
        self.last_checkpoint_path: Optional[str] = None
        self._latest_step = -1
        self._ckpt_lock = threading.Lock()
        self._ckpt_pending: List[threading.Thread] = []
        self._shutdown_done = False
        self._torn = False
        self._poisoned: Optional[Exception] = None
        self._closed_error: Optional[Exception] = None
        self._alloc: List[Tuple[Any, Any]] = []
        self._unsub = None
        self._actor_plans: Dict[bytes, _StagePlan] = {}
        self.fsdp_peers: List[List[List[Any]]] = []   # [r][i] -> peers
        self._peer_keys: set = set()
        self._in_writers: List[Any] = []      # per dp replica
        self._tgt_writers: List[Any] = []
        self._loss_readers: List[Any] = []
        self._report_readers: List[List[Any]] = []  # [r][stage]
        self._qreaders: Dict[str, Any] = {}
        # data feed (ray_tpu_torch/data/feed.py): writer specs for the
        # input edges, retained at compile time so attach_feed can hand
        # the producer role to pump actors; the feed descriptor survives
        # recover() (which re-attaches), the pump actors do not
        self._edge_specs: Dict[str, dict] = {}
        self._feed = None
        self._feed_base_step = 0  # _step_count at attach: drain accounting
        self._feed_actors: List[Any] = []
        self._feed_actor_ids: set = set()
        self.last_reports: List[dict] = []
        self.last_step_s: float = 0.0
        self._pg = None

        from ..core import runtime as runtime_mod

        rt = runtime_mod.get_runtime()
        if not hasattr(rt, "gcs"):
            raise CompiledGraphError(
                "CompiledPipelineEngine must be built on the driver")
        self._rt = rt

        try:
            self._spawn_actors(self._init_params)
            self._compile()
        except BaseException:
            try:
                self.shutdown()
            except Exception:
                pass
            raise
        if self.checkpoint_dir and self.checkpoint_every > 0:
            # step-0 commit: recover() always has a restore point, and a
            # restart-from-scratch replays the same trajectory
            self.save_checkpoint()

    # -- construction ------------------------------------------------------

    def _spawn_actors(self, chunk_params: Sequence[Any],
                      per_actor_state: Optional[List[List[dict]]] = None
                      ) -> None:
        """Spawn dp x P stage actors (and each one's fsdp - 1 peers) and
        run setup. ``chunk_params`` are G parameter trees in global chunk
        order; ``per_actor_state`` (recover/restore path) additionally
        carries each actor's get_state() payload — params land via setup,
        optimizer state via load_state afterwards. Reuses an existing
        placement group (the recover path respawns into the same
        bundles). Each stage's params go into the object store once and
        reach every dp replica of that stage by reference. With fsdp > 1
        each stage actor and its peers form their gang (a gloo world of
        their own) before setup."""
        from ..parallel.mesh_group import MeshGroup

        P, V, dp, F = self.num_stages, self.virtual, self.dp, self.fsdp
        res = dict(self._res or {"CPU": 1.0})
        strategies = self._strategies
        actor_cls = ray_tpu_torch.remote(_CGStage)
        peer_cls = ray_tpu_torch.remote(_FsdpPeer)
        if strategies is None and self._pg is None:
            self._pg = placement_group(
                [dict(res) for _ in range(P * dp * F)], strategy="SPREAD")
            if not self._pg.ready(timeout=60):
                raise TimeoutError(
                    "pipeline placement group not ready")

        def options(flat: int, k: int) -> dict:
            # rank k of stage actor ``flat``'s gang (k = 0: the stage)
            if strategies is not None:
                return dict(num_cpus=res.get("CPU", 1.0),
                            scheduling_strategy=strategies[flat])
            return dict(num_cpus=res.get("CPU", 1.0),
                        placement_group=self._pg,
                        placement_group_bundle_index=flat * F + k)

        self.actors: List[Any] = []
        self.actor_grid: List[List[Any]] = []
        self.fsdp_peers = [[[peer_cls.options(**options(r * P + i, k))
                             .remote() for k in range(1, F)]
                            for i in range(P)] for r in range(dp)]
        self._peer_keys = {p._actor_id.binary() for row in self.fsdp_peers
                           for peers in row for p in peers}
        shared = {}
        setups = []
        for r in range(dp):
            row = []
            for i in range(P):
                flat = r * P + i
                a = actor_cls.options(**options(flat, 0)).remote()
                row.append(a)
                self.actors.append(a)
                chunks = [i + v * P for v in range(V)]
                meta = [{"global": g, "first": g == 0,
                         "last": g == self.num_chunks - 1}
                        for g in chunks]
                if per_actor_state is not None:
                    cp = per_actor_state[r][i]["params"]
                else:
                    if i not in shared:
                        shared[i] = ray_tpu_torch.put(
                            [chunk_params[g] for g in chunks])
                    cp = shared[i]
                setups.append((a, (
                    i, P, V,
                    [self._fn_blobs[g] for g in chunks],
                    cp, meta, self._tx_blob,
                    self._remat, dp, r, f"zpipe-{self._gtag}-s{i}",
                    self.zero_update, self.grad_codec, self.device, F,
                    self.fsdp_peers[r][i])))
            self.actor_grid.append(row)
        if F > 1:
            # every process is starting; each gang forms as its ranks
            # come up (MeshGroup waits for them)
            device_type = torch.device(self.device or "cuda").type
            for r in range(dp):
                for i in range(P):
                    MeshGroup(F, workers=[self.actor_grid[r][i]]
                              + self.fsdp_peers[r][i],
                              device_type=device_type)
        ray_tpu_torch.get([a.setup.remote(*args) for a, args in setups],
                          timeout=self._setup_timeout)
        if per_actor_state is not None:
            loads = []
            for r in range(dp):
                for i in range(P):
                    st = per_actor_state[r][i]
                    # params already traveled through setup(); ship only
                    # the optimizer state on this second hop
                    loads.append(self.actor_grid[r][i].load_state.remote(
                        None, st["opt"], st["kind"]))
            ray_tpu_torch.get(loads, timeout=self._setup_timeout)

    def _compile(self) -> None:
        from ..cgraph.channel import (QueueChannel, RpcSender, ShmChannel,
                                      segment_size)
        from ..core.ids import ObjectId
        from ..core.object_store import SegmentReader

        rt = self._rt
        P, V, dp, M = (self.num_stages, self.virtual, self.dp,
                       self.num_microbatches)
        G = self.num_chunks
        self._segreader = SegmentReader()

        # resolve each actor's placement once (cgraph/compiled.py rules)
        plans: List[List[_StagePlan]] = []
        for r in range(dp):
            row = []
            for i in range(P):
                h = self.actor_grid[r][i]
                if rt._cgraph_actor_in_use(h._actor_id):
                    raise CompiledGraphError(
                        f"actor {h._actor_id.hex()[:8]} already "
                        f"participates in another live compiled graph")
                rt.wait_for_actor(h._actor_id, timeout=60.0)
                rec = rt._actors.get(h._actor_id)
                if rec is None or rec.worker is None \
                        or rec.node_id is None:
                    raise CompiledGraphError(
                        f"stage actor {h._actor_id.hex()[:8]} has no "
                        f"resident worker to compile onto")
                node = rt.nodes.get(rec.node_id)
                if node is None or not node.alive:
                    raise CompiledGraphError(
                        f"stage actor {h._actor_id.hex()[:8]}'s node "
                        f"is gone")
                plan = _StagePlan(h._actor_id, node, rec.worker, h, i, r)
                self._actor_plans[h._actor_id.binary()] = plan
                row.append(plan)
            plans.append(row)
        self._plans = plans

        def alloc_on(node, slots):
            cid = ObjectId.from_random()
            size = segment_size(self._channel_bytes, slots)
            if getattr(node, "is_remote", False):
                name = node.channel.call(
                    "cgraph_alloc_channel",
                    {"cid": cid, "size": size}, timeout=30)
            else:
                name = node.store.allocate_channel(cid, size)
            self._alloc.append((node, cid))
            return cid, name, size

        def make_edge(producer, consumer, edge, slots):
            """producer/consumer: "driver" or _StagePlan. Returns
            (writer_spec_or_endpoint, reader_spec_or_endpoint) — dict
            specs for plan sides, live endpoints for driver sides."""
            pnode = None if producer == "driver" else producer.node
            cnode = None if consumer == "driver" else consumer.node
            anode = cnode if cnode is not None else pnode
            same_host = (
                (pnode is None and not getattr(cnode, "is_remote",
                                               False))
                or (cnode is None and not getattr(pnode, "is_remote",
                                                  False))
                or (pnode is not None and pnode is cnode))
            if same_host:
                cid, name, size = alloc_on(anode, slots)
                spec = {"kind": "shm", "name": name, "size": size,
                        "slots": slots, "cid": cid.hex(), "edge": edge}
                if producer == "driver":
                    # retain the writer spec: attach_feed hands the
                    # producer role to a pump actor by re-opening this
                    # segment (the seq ledger is segment-resident)
                    self._edge_specs[edge] = dict(spec)
                wr = spec if producer != "driver" else ShmChannel(
                    self._segreader, name, size, edge=edge,
                    interrupt=self._stop, slots=slots)
                rd = dict(spec) if consumer != "driver" else ShmChannel(
                    self._segreader, name, size, edge=edge,
                    interrupt=self._stop, slots=slots)
                return wr, rd
            cid = ObjectId.from_random()
            if consumer == "driver":
                q = QueueChannel(cid.hex(), edge=edge,
                                 interrupt=self._stop)
                self._qreaders[cid.hex()] = q
                rt._cgraph_routes[cid.hex()] = (
                    "driver", self, None, self.graph_id)
                return {"kind": "rpc", "cid": cid.hex(),
                        "edge": edge}, q
            rt._cgraph_routes[cid.hex()] = (
                "worker", consumer.node, consumer.worker, self.graph_id)
            rspec = {"kind": "queue", "cid": cid.hex(), "edge": edge}
            if producer == "driver":
                gid = self.graph_id
                # retain an rpc writer spec: a pump actor ships the same
                # envelopes up its control channel (cgraph_send) and the
                # head routes them here, continuing at the handed-off seq
                self._edge_specs[edge] = {"kind": "rpc",
                                          "cid": cid.hex(), "edge": edge}

                def send(chan_id, seq, data, _c=consumer):
                    _c.node.worker_notify(
                        _c.worker, "cgraph_push",
                        {"graph_id": gid, "cid": chan_id,
                         "seq": seq, "data": data})

                return RpcSender(send, cid.hex(), edge=edge), rspec
            return {"kind": "rpc", "cid": cid.hex(), "edge": edge}, rspec

        def plan_of(r, g):
            return plans[r][g % P]

        # -- wire every edge, per dp replica ------------------------------
        sched = schedule_interleaved_1f1b(P, M, V)
        for r in range(dp):
            fwd_w: Dict[int, Any] = {}   # chunk g -> writer spec at g
            fwd_r: Dict[int, Any] = {}   # chunk g -> reader spec at g
            bwd_w: Dict[int, Any] = {}
            bwd_r: Dict[int, Any] = {}
            # activations: driver -> chunk0, chunk g -> g+1, loss -> driver
            wr, rd = make_edge("driver", plan_of(r, 0),
                               f"r{r}:in->c0", M)
            self._in_writers.append(wr)
            plan_of(r, 0).in_specs.append(rd)
            fwd_r[0] = rd
            for g in range(G - 1):
                wr, rd = make_edge(plan_of(r, g), plan_of(r, g + 1),
                                   f"r{r}:c{g}->c{g + 1}", M)
                fwd_w[g] = wr
                plan_of(r, g + 1).in_specs.append(rd)
                fwd_r[g + 1] = rd
            wr, rd = make_edge(plan_of(r, G - 1), "driver",
                               f"r{r}:c{G - 1}->loss", M)
            fwd_w[G - 1] = wr
            self._loss_readers.append(rd)
            # targets: driver -> last chunk's actor
            wr, rd = make_edge("driver", plan_of(r, G - 1),
                               f"r{r}:in->targets", M)
            self._tgt_writers.append(wr)
            plan_of(r, G - 1).in_specs.append(rd)
            tgt_r = rd
            # cotangents: chunk g -> g-1
            for g in range(1, G):
                wr, rd = make_edge(plan_of(r, g), plan_of(r, g - 1),
                                   f"r{r}:c{g}->c{g - 1}:grad", M)
                bwd_w[g] = wr
                plan_of(r, g - 1).in_specs.append(rd)
                bwd_r[g - 1] = rd
            # tied-grad exchange channels (both directions per pair)
            tied_w: Dict[tuple, Any] = {}
            tied_r: Dict[tuple, Any] = {}
            n_tied: Dict[tuple, int] = {}
            for (gi, ki, gj, kj) in self.tied:
                for a, b in ((gi, gj), (gj, gi)):
                    n_tied[(a, b)] = n_tied.get((a, b), 0) + 1
            for (a, b), cnt in n_tied.items():
                wr, rd = make_edge(plan_of(r, a), plan_of(r, b),
                                   f"r{r}:tied:c{a}->c{b}", cnt)
                tied_w[(a, b)] = wr
                plan_of(r, b).in_specs.append(rd)
                tied_r[(a, b)] = rd
            # per-stage end-of-step report to the driver
            reports = []
            for i in range(P):
                wr, rd = make_edge(plans[r][i], "driver",
                                   f"r{r}:s{i}->report", 2)
                reports.append(rd)
                plans[r][i]._report_w = wr
            self._report_readers.append(reports)

            # -- per-actor op schedules into node plans -------------------
            from ..core import serialization

            def const(v):
                return ("const", serialization.dumps(v))

            for i in range(P):
                plan = plans[r][i]
                ops: List[dict] = []
                for kind, v, mb in sched[i]:
                    g = v * P + i
                    # wire_codec compresses the activation/cotangent
                    # hops — fwd/bwd outputs; the loss envelope off the
                    # last chunk is a float and passes through raw
                    codec = self.wire_codec
                    if kind == "fwd":
                        args = [const(v), const(mb)]
                        args.append(("chan", fwd_r[g]["cid"]))
                        if g == G - 1:
                            args.append(("chan", tgt_r["cid"]))
                        outs = [fwd_w[g]] if g in fwd_w else []
                        ops.append({"key": f"f{g}.{mb}",
                                    "method": "forward",
                                    "num_returns": 1,
                                    "concurrency_group": "",
                                    "codec": codec,
                                    "args": args, "kwargs": {},
                                    "outs": outs})
                    else:
                        args = [const(v), const(mb)]
                        if g < G - 1:
                            args.append(("chan", bwd_r[g]["cid"]))
                        outs = [bwd_w[g]] if g in bwd_w else []
                        ops.append({"key": f"b{g}.{mb}",
                                    "method": "backward",
                                    "num_returns": 1,
                                    "concurrency_group": "",
                                    "codec": codec,
                                    "args": args, "kwargs": {},
                                    "outs": outs})
                # tied exchange: all sends first, then all receives —
                # single-pass, deadlock-free for any pair structure
                for (gi, ki, gj, kj) in self.tied:
                    for g_send, key, g_peer in ((gi, ki, gj),
                                                (gj, kj, gi)):
                        if g_send % P != i:
                            continue
                        ops.append({
                            "key": f"tg{g_send}.{key}",
                            "method": "tied_grad", "num_returns": 1,
                            "concurrency_group": "",
                            "args": [const(g_send // P), const(key)],
                            "kwargs": {},
                            "outs": [tied_w[(g_send, g_peer)]]})
                for (gi, ki, gj, kj) in self.tied:
                    for g_recv, key, g_peer in ((gi, ki, gj),
                                                (gj, kj, gi)):
                        if g_recv % P != i:
                            continue
                        ops.append({
                            "key": f"ta{g_recv}.{key}",
                            "method": "tied_add", "num_returns": 1,
                            "concurrency_group": "",
                            "args": [const(g_recv // P), const(key),
                                     ("chan",
                                      tied_r[(g_peer, g_recv)]["cid"])],
                            "kwargs": {}, "outs": []})
                ops.append({"key": f"u{i}", "method": "update",
                            "num_returns": 1, "concurrency_group": "",
                            "args": [const(1.0 / M)], "kwargs": {},
                            "outs": [plan._report_w]})
                plan.nodes = ops

        # -- register + load (routes must exist before loops start) -------
        rt._cgraph_register(self)
        for plan in self._actor_plans.values():
            payload = {"graph_id": self.graph_id,
                       "actor_id": plan.actor_id,
                       "iterative": True,
                       "stage": f"{plan.replica}.{plan.stage}",
                       "in_channels": plan.in_specs,
                       "nodes": plan.nodes}
            plan.node.worker_cgraph_call(plan.worker, "cgraph_load",
                                         payload, timeout=30.0)
        self._unsub = rt.gcs.pubsub.subscribe("actor",
                                              self._on_actor_event)

    # -- execution surface -------------------------------------------------

    def step(self, microbatches: Optional[Sequence[Any]] = None,
             targets: Optional[Sequence[Any]] = None,
             timeout: float = 300.0) -> float:
        """One full (interleaved) 1F1B training step. Takes dp * M
        microbatches/targets (tensors on any device, or numpy arrays) —
        replica r consumes the contiguous slice ``[r*M:(r+1)*M]``.
        Returns the mean loss across every microbatch of every
        replica.

        With a feed attached (:meth:`attach_feed`) call ``step()`` with
        NO batch: the pump actors already keep the input rings resident,
        so this only reads losses/reports — zero driver sends, zero
        ``.remote()`` dispatches in steady state."""
        M, dp = self.num_microbatches, self.dp
        fed = self._feed is not None
        if fed:
            if microbatches is not None or targets is not None:
                raise ValueError(
                    "a feed is attached — step() takes no batch "
                    "(detach_feed() to hand-feed again)")
        else:
            if microbatches is None or targets is None:
                raise ValueError(
                    "step() needs microbatches and targets (or attach "
                    "a feed first)")
            if len(microbatches) != M * dp or len(targets) != M * dp:
                raise ValueError(
                    f"step() needs num_microbatches*dp = {M * dp} "
                    f"microbatches, got {len(microbatches)}")
        with self._lock:
            self._check_open()
        from ..cgraph.channel import FLAG_ERROR, pack_envelope, \
            unpack_envelope
        from ..cgraph.codec import decode_value
        from ..core import serialization

        deadline = time.monotonic() + timeout
        ctx = tracing.current_context()
        trace = f"{ctx[0]}:{ctx[1]}" if ctx else ""
        if not fed:
            self._last_step_inputs = (microbatches, targets)
        if _FLREC.enabled:
            _FLREC.record("pipeline.step.begin", self._gtag,
                          {"step": self._step_count})
        t0 = time.perf_counter()
        try:
            # fed: the pumps already filled the input rings
            for r in range(0 if fed else dp):
                for m in range(M):
                    k = r * M + m
                    self._in_writers[r].send(
                        pack_envelope(0, trace, serialization.dumps(
                            _host(microbatches[k]))),
                        timeout=max(0.0, deadline - time.monotonic()))
                    self._tgt_writers[r].send(
                        pack_envelope(0, trace, serialization.dumps(
                            _host(targets[k]))),
                        timeout=max(0.0, deadline - time.monotonic()))
            losses: List[Any] = []
            first_err = None
            for r in range(dp):
                for m in range(M):
                    data = self._loss_readers[r].recv(
                        timeout=max(0.0, deadline - time.monotonic()))
                    flags, _tr, body = unpack_envelope(data)
                    val = serialization.loads(body) \
                        if flags & FLAG_ERROR else decode_value(flags, body)
                    if flags & FLAG_ERROR:
                        first_err = first_err or val
                    else:
                        losses.append(val)
            reports: List[dict] = []
            for r in range(dp):
                for rd in self._report_readers[r]:
                    data = rd.recv(
                        timeout=max(0.0, deadline - time.monotonic()))
                    flags, _tr, body = unpack_envelope(data)
                    val = serialization.loads(body) \
                        if flags & FLAG_ERROR else decode_value(flags, body)
                    if flags & FLAG_ERROR:
                        first_err = first_err or val
                    else:
                        reports.append(val)
        except CompiledGraphClosedError:
            with self._lock:
                if self._closed_error is None:
                    self._closed_error = CompiledGraphClosedError(
                        f"pipeline engine {self._gtag}: channel peer "
                        f"closed mid-step")
            self._dump_postmortem(f"step closed mid-step: "
                                  f"{self._closed_error}")
            raise self._closed_reason() from None
        except GetTimeoutError:
            self._poisoned = GetTimeoutError(
                f"pipeline engine {self._gtag}: step timed out — "
                f"in-flight state is indeterminate; shutdown() and "
                f"rebuild")
            self._dump_postmortem(f"step timeout: {self._poisoned}")
            raise
        except BaseException as e:
            # anything else raised mid-step (a serialization failure, a
            # channel-capacity error) can leave a partial round in the
            # rings — e.g. microbatch k sent with no matching target —
            # so the next step would consume stale envelopes and pair
            # activations with the wrong targets. Not resumable.
            self._poisoned = e
            self._dump_postmortem(f"step poisoned: {e!r}")
            raise
        self.last_step_s = time.perf_counter() - t0
        _H_STEP.observe(self.last_step_s, tags={"engine": self._gtag})
        if _FLREC.enabled:
            _FLREC.record("pipeline.step.end", self._gtag,
                          {"step": self._step_count,
                           "wall_ms": round(self.last_step_s * 1e3, 3)})
        if first_err is not None:
            # envelope error propagation kept every channel count
            # aligned, but residual/grad state on the stages is gone —
            # the engine is not safely resumable after a stage raise
            self._poisoned = first_err
            self._dump_postmortem(f"stage raised: {first_err!r}")
            raise first_err
        self.last_reports = reports
        self._step_count += 1
        self._maybe_checkpoint()
        return float(sum(float(l) for l in losses) / (M * dp))

    def _check_open(self) -> None:
        if self._closed_error is not None or self._torn:
            raise self._closed_reason()
        if self._poisoned is not None:
            raise CompiledGraphError(
                f"pipeline engine {self._gtag} is poisoned by an "
                f"earlier step failure ({type(self._poisoned).__name__}"
                f": {self._poisoned}); shutdown() and rebuild")

    def _closed_reason(self) -> Exception:
        err = self._closed_error
        if err is None:
            err = CompiledGraphClosedError(
                f"pipeline engine {self._gtag} was shut down")
        return type(err)(str(err))

    # -- data feed (ray_tpu_torch/data/feed.py) ----------------------------

    def attach_feed(self, feed, timeout: float = 60.0) -> None:
        """Hand the input-producer role to a :class:`ray_tpu_torch.data.
        DataFeed`: one pump actor per dp replica writes ``(inputs,
        targets)`` microbatches straight into this engine's
        pre-allocated ``in->c0`` / ``in->targets`` rings. ``step()``
        (with no batch) then only reads losses/reports — the
        tokenize→pack→shuffle→train loop runs with zero driver
        round-trips in steady state.

        Ring slot occupancy backpressures the pumps; a pump death
        aborts the engine with :class:`DataFeedError` and ``recover()``
        re-attaches; ``detach_feed()`` hands the rings back for
        hand-feeding."""
        with self._lock:
            self._check_open()
        if self._feed is not None:
            raise CompiledGraphError(
                f"pipeline engine {self._gtag} already has a feed "
                f"attached; detach_feed() first")
        if feed.dp != self.dp:
            raise ValueError(
                f"feed is sharded {feed.dp}-wide, engine dp={self.dp}")
        self._feed = feed
        self._feed_base_step = self._step_count
        try:
            self._spawn_feed(timeout)
        except BaseException:
            self._feed = None
            raise

    def _spawn_feed(self, timeout: float) -> None:
        from ..data.feed import _FeedPump
        from ..util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy

        rt = self._rt
        local_nid = next(
            (nid for nid, n in rt.nodes.items()
             if not getattr(n, "is_remote", False)), None)
        cls = ray_tpu_torch.remote(_FeedPump)
        actors: List[Any] = []
        setups = []
        for r in range(self.dp):
            in_spec = self._edge_specs.get(f"r{r}:in->c0")
            tgt_spec = self._edge_specs.get(f"r{r}:in->targets")
            if in_spec is None or tgt_spec is None:
                raise CompiledGraphError(
                    "input edge specs missing — engine not compiled")
            opts: Dict[str, Any] = {"num_cpus": 0.5}
            if (in_spec["kind"] == "shm" or tgt_spec["kind"] == "shm") \
                    and local_nid is not None:
                # shm input rings live on the head node by construction
                # (driver-producer edges): the pump must map the same
                # segments, so pin it there. rpc edges route through the
                # head and the pump can run anywhere.
                opts["scheduling_strategy"] = \
                    NodeAffinitySchedulingStrategy(local_nid, soft=False)
            a = cls.options(**opts).remote()
            # seq handoff: shm ledgers are segment-resident (no state to
            # pass); rpc writers continue at the driver's current seq
            setups.append(a.setup.remote(
                in_spec, tgt_spec,
                int(getattr(self._in_writers[r], "_seq", 0)),
                int(getattr(self._tgt_writers[r], "_seq", 0)),
                self.graph_id, self._feed.shard_blobs[r],
                f"{self._gtag}-r{r}"))
            actors.append(a)
        try:
            ray_tpu_torch.get(setups, timeout=timeout)
            ray_tpu_torch.get([a.start.remote() for a in actors],
                              timeout=timeout)
        except BaseException:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
            raise
        self._feed_actors = actors
        self._feed_actor_ids = {a._actor_id.binary() for a in actors}

    def detach_feed(self, timeout: float = 30.0) -> None:
        """Stop the pump actors and hand the input rings back to the
        driver (hand-fed ``step()`` works again). Requires a DRAINED
        feed: every pump exhausted its iterator and every fed step has
        been read by ``step()`` — otherwise stale envelopes sit in the
        rings (and the stages run ahead on them), skewing every later
        hand-fed step, so an undrained detach raises instead. Drain by
        calling ``step()`` until every fed step is consumed (build the
        factory finite if you plan to detach), or abandon the feed with
        ``shutdown()``. rpc writer seqs resync from the pumps' final
        counts."""
        if self._feed is None:
            return
        M = self.num_microbatches
        # exhausted flips a beat after the last send lands; give the
        # pump threads a moment before declaring the feed undrained
        deadline = time.monotonic() + min(5.0, timeout)
        while True:
            stats = self.feed_stats(timeout)
            read_mb = (self._step_count - self._feed_base_step) * M
            if (all(s["exhausted"] for s in stats)
                    and all(s["sent"] == read_mb for s in stats)):
                break
            if time.monotonic() >= deadline:
                raise CompiledGraphError(
                    f"detach_feed() on an undrained feed: pumps sent "
                    f"{[s['sent'] for s in stats]} microbatches "
                    f"(exhausted={[s['exhausted'] for s in stats]}) "
                    f"but step() has read "
                    f"{self._step_count - self._feed_base_step} fed "
                    f"steps x {M}; stale in-flight envelopes would "
                    f"skew every later hand-fed step. Call step() "
                    f"until every fed step is read (make the factory "
                    f"finite), or abandon the feed via shutdown().")
            time.sleep(0.05)
        # clear the watch set FIRST: the kills below must not look like
        # a feed fault to _on_actor_event
        actors, self._feed_actors = self._feed_actors, []
        self._feed_actor_ids = set()
        self._feed = None
        for r, a in enumerate(actors):
            try:
                st = ray_tpu_torch.get(a.stop.remote(), timeout=timeout)
                for w, key in ((self._in_writers[r], "in_seq"),
                               (self._tgt_writers[r], "tgt_seq")):
                    if hasattr(w, "_seq") and st.get(key) is not None:
                        w._seq = int(st[key])
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass

    def feed_stats(self, timeout: float = 30.0) -> List[dict]:
        """Per-replica pump stats: {sent, exhausted, error, ...}."""
        if not self._feed_actors:
            return []
        return ray_tpu_torch.get(
            [a.stats.remote() for a in self._feed_actors], timeout=timeout)

    # -- not ported yet ----------------------------------------------------

    def enable_elastic(self, *, min_dp: int = 1,
                       max_dp: Optional[int] = None,
                       grow_on_join: bool = True) -> None:
        raise _not_ported("elastic capacity (enable_elastic)",
                          "A7: the autoscaler and the serve control plane")

    def resize(self, dp: int, timeout: float = 300.0,
               scheduling_strategies: Optional[Sequence] = None) -> int:
        raise _not_ported("elastic capacity (resize)",
                          "A7: the autoscaler and the serve control plane")

    # -- performance introspection -----------------------------------------

    def _dump_postmortem(self, reason: str) -> Optional[str]:
        """Merged driver+worker flight-recorder bundle: drains this
        process's ring plus — best-effort, 5s per worker — every stage
        worker still reachable. Throttled inside dump_bundle; never
        raises (the abort being recorded takes precedence)."""
        try:
            from ..perf.postmortem import dump_bundle

            fetchers = {}
            for plan in self._actor_plans.values():
                name = f"worker:{plan.replica}.{plan.stage}"
                fetchers[name] = (
                    lambda p=plan: p.node.worker_cgraph_call(
                        p.worker, "flightrec_snapshot", {}, timeout=5.0))
            return dump_bundle(
                reason, origin="driver", ring_fetchers=fetchers,
                meta={"engine": self._gtag, "dp": self.dp,
                      "num_stages": self.num_stages,
                      "num_microbatches": self.num_microbatches,
                      "step": self._step_count, "reason": reason})
        except Exception:
            return None

    def profile(self, steps: int = 4, microbatches: Sequence[Any] = None,
                targets: Sequence[Any] = None,
                tokens_per_step: Optional[float] = None,
                flops_per_token: Optional[float] = None,
                peak_flops: Optional[float] = None,
                timeout: float = 300.0):
        """Run one warmup step plus ``steps`` profiled training steps
        and return a :class:`ray_tpu_torch.perf.StepReport` with the
        per-stage exec/bubble/sync breakdown, per-op wall spans (chrome-
        trace exportable), measured bubble fraction, tokens/s and MFU.

        ``microbatches``/``targets`` default to replaying the last
        ``step()``'s inputs — profiling trains on them, exactly as
        ``step()`` would. ``tokens_per_step`` enables tokens/s;
        ``flops_per_token`` + ``peak_flops`` (default
        ``RAY_TPU_PEAK_FLOPS``) enable MFU."""
        from ..perf.report import StepReport

        if microbatches is None or targets is None:
            last = getattr(self, "_last_step_inputs", None)
            if last is None:
                raise ValueError(
                    "profile() without microbatches/targets needs at "
                    "least one prior step() to replay")
            microbatches, targets = last
        if peak_flops is None:
            peak_flops = float(os.environ.get("RAY_TPU_PEAK_FLOPS", 0))
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        # warmup step doubles as the cumulative-counter baseline: the
        # executor's exec/bubble sinks count from graph load, so the
        # profiled window is (final - baseline)
        self.step(microbatches, targets, timeout=timeout)
        base = {f"{r['dp_rank']}.{r['stage']}": dict(r.get("perf") or {})
                for r in self.last_reports}
        t_start = time.time()
        wall0 = time.perf_counter()
        step_ms: List[float] = []
        sync_acc: Dict[str, float] = {}
        upd_acc: Dict[str, float] = {}
        ops_acc: Dict[str, List[dict]] = {}
        final: Dict[str, dict] = {}
        for _ in range(steps):
            self.step(microbatches, targets, timeout=timeout)
            step_ms.append(self.last_step_s * 1e3)
            for r in self.last_reports:
                tag = f"{r['dp_rank']}.{r['stage']}"
                sync_acc[tag] = sync_acc.get(tag, 0.0) \
                    + float(r.get("sync_ms", 0.0))
                upd_acc[tag] = upd_acc.get(tag, 0.0) \
                    + float(r.get("update_ms", 0.0))
                perf = r.get("perf") or {}
                ops_acc.setdefault(tag, []).extend(perf.get("ops", ()))
                final[tag] = perf
        wall_s = time.perf_counter() - wall0
        stages = []
        for tag in sorted(final):
            b = base.get(tag, {})
            f = final[tag]
            bubble_ms = (f.get("bubble_s", 0.0)
                         - b.get("bubble_s", 0.0)) * 1e3
            stages.append({
                "stage": tag,
                "exec_ms": round((f.get("exec_s", 0.0)
                                  - b.get("exec_s", 0.0)) * 1e3, 3),
                # in this engine the 1F1B bubble IS recv-blocked time —
                # the executor times only the blocking channel read
                "bubble_ms": round(bubble_ms, 3),
                "recv_ms": round(bubble_ms, 3),
                "send_ms": round((f.get("send_s", 0.0)
                                  - b.get("send_s", 0.0)) * 1e3, 3),
                "sync_ms": round(sync_acc.get(tag, 0.0), 3),
                "update_ms": round(upd_acc.get(tag, 0.0), 3),
                "ops": ops_acc.get(tag, []),
            })
        n_inst = max(1, len(stages))
        phases = {
            "compute": round(sum(s["exec_ms"] for s in stages) / n_inst,
                             3),
            "bubble": round(sum(s["bubble_ms"] for s in stages) / n_inst,
                            3),
            "send": round(sum(s["send_ms"] for s in stages) / n_inst, 3),
        }
        tokens = float(tokens_per_step or 0.0) * steps
        events = [ev for ev in _FLREC.snapshot(clear=False)
                  if ev["ts"] >= t_start][-2000:]
        return StepReport(
            kind="pipeline", engine=self._gtag, steps=steps,
            wall_s=wall_s, step_ms=step_ms, stages=stages, phases=phases,
            tokens=tokens,
            tokens_per_s=tokens / wall_s if tokens and wall_s > 0 else 0.0,
            flops_per_token=float(flops_per_token or 0.0),
            peak_flops=peak_flops, num_stages=self.num_stages,
            num_microbatches=self.num_microbatches, events=events,
            extra={"dp": self.dp})

    def get_params(self) -> List[Any]:
        """Chunk params in GLOBAL chunk order (replica 0's copy), as CPU
        tensors."""
        P = self.num_stages
        per_actor = ray_tpu_torch.get(
            [a.get_params.remote() for a in self.actor_grid[0]],
            timeout=120)
        return [per_actor[g % P][g // P] for g in range(self.num_chunks)]

    def opt_state_bytes(self) -> List[int]:
        """Per-stage optimizer-state bytes on replica 0 (the ~1/dp
        ZeRO shrink shows up here)."""
        return ray_tpu_torch.get(
            [a.opt_state_bytes.remote() for a in self.actor_grid[0]],
            timeout=60)

    def placement(self, timeout: float = 60.0) -> List[List[dict]]:
        """[r][i] -> stage (r, i)'s ``placement()``: its worker pid,
        device, device bytes held and peak, parameter bytes, hand-written
        kernel launches and channel bytes by edge. Called between
        steps."""
        refs = [[a.placement.remote() for a in row]
                for row in self.actor_grid]
        return [ray_tpu_torch.get(row, timeout=timeout) for row in refs]

    # -- checkpoint / restore ----------------------------------------------

    def _pull_state_grid(self, timeout: float = 120.0) -> List[List[dict]]:
        """[r][i] -> stage get_state() payload, pulled over the dynamic
        path (the iterative loops are idle between steps)."""
        refs = [[a.get_state.remote() for a in row]
                for row in self.actor_grid]
        return [ray_tpu_torch.get(row, timeout=timeout) for row in refs]

    def save_checkpoint(self, blocking: bool = False) -> str:
        """Snapshot every stage's params + optimizer state at the current
        step boundary and commit it to ``checkpoint_dir`` atomically
        (write to a temp file, ``os.replace`` into place, then replace
        the LATEST pointer). The state pull is synchronous — it must see
        a step boundary — but the serialization + disk IO runs on a
        background thread unless ``blocking``. Returns the target path
        (readable once committed; ``wait_for_checkpoints()`` joins)."""
        if not self.checkpoint_dir:
            raise ValueError(
                "save_checkpoint() needs checkpoint_dir= at construction")
        with self._lock:
            self._check_open()
        step = self._step_count
        states = self._pull_state_grid()
        path = os.path.join(self.checkpoint_dir, f"ckpt-{step:08d}.pkl")
        payload = {
            "step": step,
            "engine": self._engine_meta(),
            "states": states,
        }

        def _write() -> None:
            tmp = path + f".tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    cloudpickle.dump(payload, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)  # rename-commit: readers never
                # observe a torn checkpoint
                with self._ckpt_lock:
                    # concurrent writer threads can finish out of order
                    # (a large step-N pickle outliving step-N+1's): only
                    # advance LATEST, never roll it back to an older step
                    if step < self._latest_step:
                        return
                    latest_tmp = os.path.join(
                        self.checkpoint_dir, f"LATEST.tmp.{os.getpid()}")
                    with open(latest_tmp, "w") as f:
                        f.write(os.path.basename(path))
                    os.replace(latest_tmp,
                               os.path.join(self.checkpoint_dir,
                                            "LATEST"))
                    self._latest_step = step
                    self.last_checkpoint_path = path
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass

        if blocking:
            _write()
        else:
            t = threading.Thread(target=_write, daemon=True,
                                 name=f"pipeline-ckpt-{self._gtag}")
            with self._ckpt_lock:
                self._ckpt_pending = [
                    p for p in self._ckpt_pending if p.is_alive()]
                self._ckpt_pending.append(t)
            t.start()
        return path

    def wait_for_checkpoints(self, timeout: float = 60.0) -> None:
        """Join every in-flight async checkpoint write."""
        with self._ckpt_lock:
            pending = list(self._ckpt_pending)
        deadline = time.monotonic() + timeout
        for t in pending:
            t.join(max(0.0, deadline - time.monotonic()))

    def _engine_meta(self) -> dict:
        return {"num_chunks": self.num_chunks,
                "num_stages": self.num_stages,
                "virtual": self.virtual, "dp": self.dp,
                "fsdp": self.fsdp,
                "zero_update": self.zero_update,
                "grad_codec": self.grad_codec,
                "num_microbatches": self.num_microbatches}

    def _maybe_checkpoint(self) -> None:
        if self.checkpoint_dir and self.checkpoint_every > 0 \
                and self._step_count % self.checkpoint_every == 0:
            self.save_checkpoint()

    @staticmethod
    def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
        """Newest committed checkpoint path in a directory (via the
        LATEST pointer; falls back to a name scan)."""
        ptr = os.path.join(checkpoint_dir, "LATEST")
        try:
            with open(ptr) as f:
                path = os.path.join(checkpoint_dir, f.read().strip())
            if os.path.exists(path):
                return path
        except OSError:
            pass
        cands = sorted(
            n for n in (os.listdir(checkpoint_dir)
                        if os.path.isdir(checkpoint_dir) else ())
            if n.startswith("ckpt-") and n.endswith(".pkl"))
        return os.path.join(checkpoint_dir, cands[-1]) if cands else None

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        with open(path, "rb") as f:
            return cloudpickle.load(f)

    def restore(self, checkpoint: str) -> int:
        """Load a committed checkpoint into the LIVE engine (fresh-build
        restart path): every stage's params + optimizer state replace the
        current ones at the next step boundary. Returns the restored
        step count. ``recover()`` is the respawn-then-restore path for an
        engine whose stages died."""
        ckpt = self.load_checkpoint(checkpoint)
        self._check_ckpt_shape(ckpt)
        with self._lock:
            self._check_open()
        loads = []
        for r in range(self.dp):
            for i in range(self.num_stages):
                st = ckpt["states"][r][i]
                loads.append(self.actor_grid[r][i].load_state.remote(
                    st["params"], st["opt"], st["kind"]))
        ray_tpu_torch.get(loads, timeout=self._setup_timeout)
        self._step_count = int(ckpt["step"])
        return self._step_count

    def _check_ckpt_shape(self, ckpt: dict) -> None:
        want = {"num_chunks": self.num_chunks, "virtual": self.virtual,
                "dp": self.dp, "fsdp": self.fsdp,
                "zero_update": self.zero_update}
        have = {k: ckpt.get("engine", {}).get(k, 1 if k == "fsdp" else None)
                for k in want}
        if have != want:
            raise ValueError(
                f"checkpoint shape {have} does not match engine {want}")

    # -- recovery ----------------------------------------------------------

    def recover(self, checkpoint: Optional[str] = None,
                timeout: float = 120.0) -> int:
        """Bring a faulted engine back: tear down whatever channels are
        left (idempotent — a stage-death abort already did most of it),
        kill and respawn EVERY stage actor (survivors hold residual/grad
        state from the aborted step and must not leak it into the resumed
        trajectory), recompile channels under a fresh graph id, and
        restore from ``checkpoint`` (default: the newest commit in
        checkpoint_dir, else a step-0 restart from the construction-time
        params). Returns the step count training resumes from.

        The resumed loss trajectory is bit-identical to a clean restart
        from the same checkpoint: both paths run the same chunk programs
        over the same restored tensors."""
        deadline = time.monotonic() + timeout
        self.wait_for_checkpoints()
        # serialize against an in-flight abort teardown, then reset
        self.teardown()
        ckpt_path = checkpoint
        if ckpt_path is None and self.checkpoint_dir:
            ckpt_path = self.latest_checkpoint(self.checkpoint_dir)
        state_grid = None
        step = 0
        if ckpt_path is not None:
            ckpt = self.load_checkpoint(ckpt_path)
            if int(ckpt.get("engine", {}).get("dp", self.dp)) != self.dp:
                # a commit written at another width: re-shard it to the
                # engine's width (bit-exact byte movement)
                ckpt = reshard_checkpoint(ckpt, self.dp)
            self._check_ckpt_shape(ckpt)
            state_grid = ckpt["states"]
            step = int(ckpt["step"])
        self._kill_stages_and_wait(deadline, "recover()")
        self._destroy_collective_groups()
        self._drop_pg_if_degraded()
        self._reset_graph_state()
        self._spawn_actors(self._init_params,
                           per_actor_state=state_grid)
        self._compile()
        if self._feed is not None:
            # re-attach: fresh pump actors over the recompiled rings.
            # The shard factories restart their iterators — the resumed
            # trajectory replays from the restored checkpoint exactly
            # like a clean restart would.
            self._spawn_feed(
                max(1.0, min(60.0, deadline - time.monotonic())))
            # pump iterators restarted from scratch: fed-step drain
            # accounting (detach_feed) restarts with them
            self._feed_base_step = step
        self._step_count = step
        return step

    def _drop_pg_if_degraded(self) -> None:
        """A bundle whose node died would strand the respawn — actor
        creations against a dead bundle park forever. Drop the group so
        the respawn sizes a fresh one over the nodes that remain."""
        if self._pg is None:
            return
        degraded = True
        try:
            info = self._rt.gcs.get_pg(self._pg.id)
            if info is not None:
                degraded = False
                for nid in info.bundle_nodes:
                    node = self._rt.nodes.get(nid) if nid else None
                    if node is None or not node.alive \
                            or getattr(node, "draining", False):
                        degraded = True
                        break
        except Exception:
            pass
        if degraded:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    def _destroy_collective_groups(self) -> None:
        """Kill the dp collective groups' detached rendezvous store
        actors from the DRIVER (named ``rtpu_collective:<group>:<dp>``).
        recover() kills the stage actors without a cleanup() hop, so the
        stores would otherwise leak. Must run while the OLD gtag/dp are
        current."""
        if self.dp <= 1 or self._tx_blob is None:
            return
        for i in range(self.num_stages):
            name = f"rtpu_collective:zpipe-{self._gtag}-s{i}:{self.dp}"
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(name))
            except Exception:
                pass

    def _all_actors(self) -> List[Any]:
        """Every stage actor and fsdp peer of the engine."""
        return list(getattr(self, "actors", [])) + [
            p for row in self.fsdp_peers for peers in row for p in peers]

    def _kill_stages_and_wait(self, deadline: float, what: str) -> None:
        """Kill every stage actor and fsdp peer (dead ones no-op) and wait
        for the records to reach DEAD so placement slots free up for a
        respawn."""
        for a in self._all_actors():
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        for a in self._all_actors():
            while self._rt.actor_state(a._actor_id) not in ("DEAD",):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"actor {a._actor_id.hex()[:8]} did not "
                        f"reach DEAD during {what}")
                time.sleep(0.05)

    def _reset_graph_state(self) -> None:
        """Reset engine plumbing for a fresh compile (recover)."""
        with self._lock:
            self._torn = False
            self._poisoned = None
            self._closed_error = None
        self._stop = threading.Event()
        self.graph_id = os.urandom(16)
        self._gtag = self.graph_id.hex()[:8]
        self._actor_plans = {}
        self._alloc = []
        self._in_writers = []
        self._tgt_writers = []
        self._loss_readers = []
        self._report_readers = []
        self._qreaders = {}
        self._edge_specs = {}
        self._feed_actors = []
        self._feed_actor_ids = set()
        self._unsub = None
        self._shutdown_done = False

    def _deliver(self, cid: str, seq: int, data: bytes) -> None:
        q = self._qreaders.get(cid)
        if q is not None:
            q.deliver(seq, data)

    def _on_actor_event(self, msg) -> None:
        try:
            actor_id, state = msg
        except Exception:
            return
        from ..core.gcs import ActorState

        if state != ActorState.DEAD:
            return
        key = actor_id.binary() if hasattr(actor_id, "binary") else None
        if (key in self._actor_plans or key in self._peer_keys) \
                and not self._torn:
            self._abort(CompiledGraphClosedError(
                f"pipeline engine {self._gtag}: stage actor or fsdp peer "
                f"{actor_id.hex()[:8]} died while the engine was live"))
        elif key in self._feed_actor_ids and not self._torn:
            # feed pumps are a stateless tier, but a dead pump leaves
            # the input rings starved mid-round — typed error so the
            # caller knows recover() (which re-attaches) is the fix
            self._abort(DataFeedError(
                f"pipeline engine {self._gtag}: data-feed pump "
                f"{actor_id.hex()[:8]} died while the engine was live; "
                f"recover() respawns the stages and re-attaches the "
                f"feed"))

    def _abort(self, err: Exception) -> None:
        with self._lock:
            if self._closed_error is None:
                self._closed_error = err
        # unblock any in-flight step() NOW (driver endpoints poll this),
        # and run the teardown off-thread: this is called from the GCS
        # pubsub callback, and blocking control-plane calls made from
        # that thread can't be serviced until the callback returns
        self._stop.set()

        def _dump_and_teardown():
            # ring fetch is a blocking control-plane call — it can only
            # run here, never in the pubsub callback itself
            self._dump_postmortem(f"abort: {err!r}")
            self.teardown()

        threading.Thread(target=_dump_and_teardown, daemon=True,
                         name=f"pipeline-abort-{self._gtag}").start()

    def teardown(self) -> None:
        """Stop the resident loops and release every channel segment
        (leak-asserted in tests); actors stay alive. Idempotent; a
        second caller blocks until the first finishes releasing."""
        with self._teardown_lock:
            self._teardown_locked()

    def _teardown_locked(self) -> None:
        with self._lock:
            if self._torn:
                return
            self._torn = True
            if self._closed_error is None:
                self._closed_error = CompiledGraphClosedError(
                    f"pipeline engine {self._gtag} was shut down")
        self._stop.set()
        if self._unsub is not None:
            try:
                self._unsub()
            except Exception:
                pass
        # feed pumps go first: clear the watch set (their deaths must
        # not re-abort), then kill — blocked sends unwedge when the
        # ring ledgers are poisoned below. The feed DESCRIPTOR stays:
        # recover() re-attaches from it.
        feed_actors, self._feed_actors = self._feed_actors, []
        self._feed_actor_ids = set()
        for a in feed_actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        endpoints = (self._in_writers + self._tgt_writers
                     + self._loss_readers
                     + [rd for row in self._report_readers for rd in row])
        for ch in endpoints:
            try:
                ch.mark_closed()
            except Exception:
                pass
        for plan in self._actor_plans.values():
            try:
                plan.node.worker_cgraph_call(
                    plan.worker, "cgraph_stop",
                    {"graph_id": self.graph_id}, timeout=10.0)
            except Exception:
                pass
        for ch in endpoints:
            try:
                ch.close()
            except Exception:
                pass
        for node, cid in self._alloc:
            try:
                if getattr(node, "is_remote", False):
                    node.channel.call("cgraph_release_channel",
                                      {"cid": cid}, timeout=10)
                else:
                    node.store.release_channel(cid)
            except Exception:
                pass
        self._alloc = []
        try:
            self._rt._cgraph_unregister(self)
        except Exception:
            pass

    def shutdown(self) -> None:
        """Full teardown: stop loops, release channels, destroy dp
        collective groups, kill the stage actors, drop the placement
        group. Idempotent under double-invocation (atexit + signal
        handler + explicit call); a reentrant call returns once teardown
        marked the engine torn."""
        self.teardown()
        try:
            self.wait_for_checkpoints(timeout=30.0)
        except Exception:
            pass
        with self._ckpt_lock:
            if self._shutdown_done:
                return
            self._shutdown_done = True
        if self.dp > 1 and getattr(self, "actor_grid", None):
            try:
                ray_tpu_torch.get(
                    [row[i].cleanup.remote()
                     for row in self.actor_grid[:1]
                     for i in range(len(row))], timeout=30)
            except Exception:
                pass
            # backstop: when the stages are already dead (post-abort
            # shutdown) the cleanup hop failed — kill the rendezvous
            # stores from the driver so nothing detached leaks
            self._destroy_collective_groups()
        for a in self._all_actors():
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass

    def __del__(self):
        try:
            if not self._torn:
                self.teardown()
        except Exception:
            pass
