"""Pipeline schedules and the in-program pipeline (counterpart of
ray_tpu/parallel/pipeline.py, with its names).

``schedule_1f1b`` is the explicit per-stage 1F1B order (warmup forwards,
then alternating one-forward-one-backward, then the remaining backwards);
``schedule_interleaved_1f1b`` the per-actor order when each actor hosts
several model chunks. Both are copied as they are (pure Python). The
actor-hosted engine (``ray_tpu_torch.train.pipeline_cgraph``) compiles
the latter into each stage actor's op list.

``pipeline_spmd`` is the in-program collective pipeline: one program on
every rank of a mesh's pp axis (a gang of ranks, ``MeshGroup``), GPipe's
schedule over ticks, whose backward is the transposed program, as JAX's
AD gives it. ``stack_stages`` splits stacked ``[L, ...]`` layer params
into ``[P, L/P, ...]`` stages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["schedule_1f1b", "schedule_interleaved_1f1b", "pipeline_spmd",
           "stack_stages"]


def schedule_1f1b(num_stages: int, num_microbatches: int
                  ) -> List[List[Tuple[str, int]]]:
    """Per-stage operation order for one training step.

    Returns `sched[stage] = [("fwd", mb) | ("bwd", mb), ...]` with the
    classic 1F1B structure: stage i runs `min(num_stages - i, M)` warmup
    forwards, then alternates one-forward-one-backward, then drains the
    remaining backwards. Properties (asserted by tests):
      - each stage does M forwards and M backwards, each microbatch once;
      - backward of mb j on stage i only after forward of mb j on stage i;
      - in-flight forwards on stage i never exceed num_stages - i
        (the activation-memory bound that motivates 1F1B over GPipe).
    """
    P_, M = num_stages, num_microbatches
    sched: List[List[Tuple[str, int]]] = []
    for i in range(P_):
        ops: List[Tuple[str, int]] = []
        warmup = min(P_ - i, M)
        f = b = 0
        for _ in range(warmup):
            ops.append(("fwd", f))
            f += 1
        while b < M:
            ops.append(("bwd", b))
            b += 1
            if f < M:
                ops.append(("fwd", f))
                f += 1
        sched.append(ops)
    return sched


def schedule_interleaved_1f1b(num_stages: int, num_microbatches: int,
                              virtual: int = 1
                              ) -> List[List[Tuple[str, int, int]]]:
    """Per-ACTOR op order for interleaved 1F1B with ``virtual`` model
    chunks per actor (the Megatron/MPMD interleaved schedule shape:
    actor i hosts global chunks i, i+P, i+2P, ...).

    Returns ``sched[actor] = [(kind, v, mb), ...]`` where ``v`` is the
    local virtual-stage index (global chunk ``g = v*P + i``). For
    virtual == 1 this is exactly :func:`schedule_1f1b` lifted to
    triples, so the non-interleaved engine path keeps the proven
    schedule bit-for-bit.

    For virtual > 1 the order comes from a tick-based list-scheduling
    simulation: each actor executes at most one op per tick, preferring
    a ready backward (eager-backward bounds in-flight activations),
    else the shallowest ready forward. Because the emitted per-actor
    order IS a linear extension of the fwd/bwd dependency DAG realized
    by the simulation, executing it with blocking channel reads (and
    non-blocking sends, i.e. >= M slots per edge) cannot deadlock.
    """
    P_, M, V = num_stages, num_microbatches, virtual
    if V <= 1:
        return [[(kind, 0, mb) for kind, mb in ops]
                for ops in schedule_1f1b(P_, M)]
    G = P_ * V
    done: Dict[Tuple[str, int, int], int] = {}  # (kind, g, mb) -> tick
    fnext = [0] * G  # next fwd microbatch per global chunk
    bnext = [0] * G  # next bwd microbatch per global chunk
    sched: List[List[Tuple[str, int, int]]] = [[] for _ in range(P_)]
    t = 0
    total = 2 * G * M
    while len(done) < total:
        progressed = False
        picks = []
        for i in range(P_):
            best = None
            for v in range(V):
                g = v * P_ + i
                mb = bnext[g]
                if mb < M and ("fwd", g, mb) in done \
                        and done[("fwd", g, mb)] <= t \
                        and (g == G - 1
                             or done.get(("bwd", g + 1, mb), t + 1) <= t):
                    cand = ("bwd", v, mb, g)
                    # drain the oldest microbatch first, deepest chunk
                    # first (its grad unblocks the longest chain)
                    if best is None \
                            or (cand[2], -cand[3]) < (best[2], -best[3]):
                        best = cand
            if best is None:
                for v in range(V):
                    g = v * P_ + i
                    mb = fnext[g]
                    if mb < M and (g == 0
                                   or done.get(("fwd", g - 1, mb),
                                               t + 1) <= t):
                        cand = ("fwd", v, mb, g)
                        # fill shallow chunks first: warmup order
                        if best is None or (cand[1], cand[2]) \
                                < (best[1], best[2]):
                            best = cand
            if best is not None:
                kind, v, mb, g = best
                picks.append((kind, g, mb))
                sched[i].append((kind, v, mb))
                if kind == "fwd":
                    fnext[g] += 1
                else:
                    bnext[g] += 1
                progressed = True
        # ops picked this tick complete at t+1 (unit latency keeps the
        # realized order consistent with the cross-actor dependencies)
        for kind, g, mb in picks:
            done[(kind, g, mb)] = t + 1
        t += 1
        if not progressed and len(done) < total:
            raise RuntimeError(
                "interleaved 1F1B simulation stalled (bug): "
                f"P={P_} M={M} V={V} done={len(done)}/{total}")
    return sched


# ---------------------------------------------------------------------------
# In-program collective pipeline (GPipe schedule; autograd runs the
# transposed program, the reverse pipeline)
# ---------------------------------------------------------------------------


def _mesh_owner(mesh):
    """A MeshOwner for ``mesh``: itself, or one adopting a DeviceMesh."""
    from .sharding.owner import MeshOwner

    if isinstance(mesh, MeshOwner):
        return mesh
    return MeshOwner.from_mesh(mesh, name="pipeline_spmd")


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (a MeshOwner or a DeviceMesh)."""
    sizes = _mesh_owner(mesh).axis_sizes
    if axis not in sizes:
        raise ValueError(f"mesh axes {list(sizes)} have no {axis!r} axis")
    return sizes[axis]


def pipeline_spmd(stage_fn: Callable[[Any, Any], Any],
                  stage_params: Any,
                  x_mb,
                  mesh,
                  pp_axis: str = "pp"):
    """Run ``stage_fn`` over P pipeline stages for M microbatches, on
    every rank of the mesh's ``pp_axis``.

    stage_params: a tree whose leaves have leading axis P (one slice per
        stage), the whole stack on every rank; each rank runs its own
        slice.
    x_mb: [M, ...] microbatched input of stage 0, the same on every rank.
    mesh: a MeshOwner or a DeviceMesh over the ranks of a gang; its other
        axes hold replicas, which run the same program.
    Returns the [M, ...] outputs of the last stage on every rank of the
    pp axis.

    At P > 1 it is the reference's program: M + P - 1 ticks, in each of
    which every stage runs ``stage_fn`` (on stage 0 microbatch t, on the
    others what the previous stage sent at the tick before; the ticks
    that carry no microbatch are computed and discarded, so every rank
    runs the same graph), the ring ``ppermute`` between ticks, and a
    ``psum`` of the last stage's outputs. Differentiable: the backward
    runs the transposes (``parallel.sharding.lower``), so the gradient
    of every leaf of ``stage_params`` and of ``x_mb`` is the whole one on
    every rank: the stacked params and ``x_mb`` enter through ``pvary``,
    whose backward sums every rank's cotangent over pp (each rank's
    stage row, and stage 0's input cotangent, with exact zeros
    elsewhere).
    """
    import torch

    from .mesh import PartitionSpec as P
    from .sharding.lower import (axis_index, lower_shard_map, ppermute,
                                 psum, pvary)
    from .sharding.owner import _tree_map

    owner = _mesh_owner(mesh)
    P_ = axis_size(owner, pp_axis)
    M = x_mb.shape[0]
    if P_ == 1:
        sp = _tree_map(lambda a: a[0], stage_params)
        return torch.stack([stage_fn(sp, x_mb[i]) for i in range(M)])

    perm = [(i, (i + 1) % P_) for i in range(P_)]
    ticks = M + P_ - 1

    def body(stacked, x):
        idx = axis_index(pp_axis)
        stacked = pvary(stacked, pp_axis, name="stage_params")
        x = pvary(x, pp_axis, name="x_mb")
        sp = _tree_map(lambda a: a[idx], stacked)
        first = torch.tensor(idx == 0, device=x.device)
        last = torch.tensor(idx == P_ - 1, device=x.device)
        state = torch.zeros_like(x[0])
        ys = []
        for t in range(ticks):
            out = stage_fn(sp, torch.where(first, x[min(t, M - 1)], state))
            if t >= P_ - 1:
                # stage P-1 emitted microbatch t - (P-1) this tick
                ys.append(out)
            if t < ticks - 1:          # the last tick's send feeds nothing
                state = ppermute(out, pp_axis, perm, name="tick")
        # only the last stage holds real outputs; replicate over the ring
        y = torch.stack(ys)
        return psum(torch.where(last, y, torch.zeros_like(y)), pp_axis,
                    name="output")

    # the whole stack and x_mb enter replicated; pvary and the row taken
    # in the body make them per-stage
    run = lower_shard_map(body, owner, in_specs=(P(), P()),
                          out_specs=P(), axis_names=frozenset({pp_axis}))
    return run(stage_params, x_mb)


def stack_stages(layer_params: Dict[str, Any], num_stages: int
                 ) -> Dict[str, Any]:
    """[L, ...] stacked per-layer params -> [P, L/P, ...] per-stage."""
    out = {}
    for k, v in layer_params.items():
        L = v.shape[0]
        if L % num_stages:
            raise ValueError(
                f"{k}: {L} layers not divisible into {num_stages} stages")
        out[k] = v.reshape(num_stages, L // num_stages, *v.shape[1:])
    return out
