"""Pipeline schedules (counterpart of the schedules in
ray_tpu/parallel/pipeline.py, copied as they are: pure Python).

``schedule_1f1b`` is the explicit per-stage 1F1B order (warmup forwards,
then alternating one-forward-one-backward, then the remaining backwards);
``schedule_interleaved_1f1b`` the per-actor order when each actor hosts
several model chunks. The actor-hosted engine
(``ray_tpu_torch.train.pipeline_cgraph``) compiles the latter into each
stage actor's op list.

Not here: the in-program collective pipeline ``pipeline_spmd`` and
``stack_stages``, which run over a device mesh (ROADMAP A4.3).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["schedule_1f1b", "schedule_interleaved_1f1b"]


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
