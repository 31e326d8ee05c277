"""Cluster scheduling policies.

Equivalent of the reference's policy suite
(ref: src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:50 —
pack-until-threshold-then-spread with spread threshold 0.5 from
ray_config_def.h:193; spread_scheduling_policy.cc; node_affinity_...;
bundle_scheduling_policy.cc for PACK/SPREAD/STRICT_PACK/STRICT_SPREAD;
composed via composite_scheduling_policy.h:32).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from .ids import NodeId
from .resources import ResourceSet, res_ge, res_sub
from .task_spec import SchedulingStrategy


@dataclass
class NodeView:
    node_id: NodeId
    total: ResourceSet
    available: ResourceSet
    alive: bool = True
    # labels, e.g. {"tpu_slice": "v5e-16-0", "host": "..."}
    labels: Dict[str, str] = None


def _utilization(view: NodeView) -> float:
    """Max utilization across resource dimensions the node actually has."""
    util = 0.0
    for k, total in view.total.items():
        if total > 0:
            used = total - view.available.get(k, 0.0)
            util = max(util, used / total)
    return util


def _feasible(view: NodeView, demand: ResourceSet) -> bool:
    return view.alive and res_ge(view.total, demand)


def _has_available(view: NodeView, demand: ResourceSet) -> bool:
    return view.alive and res_ge(view.available, demand)


class Scheduler:
    """Picks a node for a resource demand + strategy. The caller holds the
    authoritative per-node availability (cluster view fed by the syncer)."""

    def __init__(self, spread_threshold: float = 0.5, seed: int = 0):
        self.spread_threshold = spread_threshold
        self._rr_counter = 0
        self._rng = random.Random(seed)

    def pick_node(
        self,
        views: List[NodeView],
        demand: ResourceSet,
        strategy: SchedulingStrategy,
        local_node_id: Optional[NodeId] = None,
        locality: Optional[Dict[NodeId, int]] = None,
    ) -> Optional[NodeId]:
        if strategy.kind == "NODE_AFFINITY":
            target = next((v for v in views if v.node_id == strategy.node_id), None)
            if target is not None and _has_available(target, demand):
                return target.node_id
            if strategy.soft:
                return self._hybrid(views, demand, local_node_id)
            if target is not None and _feasible(target, demand):
                return target.node_id  # queue on that node until resources free
            return None
        if strategy.kind == "SPREAD":
            return self._spread(views, demand)
        # Locality-aware default policy (ref: core_worker/lease_policy.cc
        # LocalityAwareLeasePolicy::GetBestNodeForTask — request the lease
        # from the node holding the most argument bytes): a node already
        # holding the args skips one or two DCN hops per argument. Only a
        # node that can run the task NOW wins on locality; otherwise fall
        # through to hybrid packing.
        if locality:
            ranked = sorted(
                (v for v in views
                 if locality.get(v.node_id) and _has_available(v, demand)),
                key=lambda v: -locality[v.node_id])
            if ranked:
                return ranked[0].node_id
        return self._hybrid(views, demand, local_node_id)

    # -- hybrid: pack onto low-utilization nodes (local first) until the
    # spread threshold, then prefer least-utilized (ref: hybrid_scheduling_policy.h:61)
    def _hybrid(self, views: List[NodeView], demand: ResourceSet,
                local_node_id: Optional[NodeId]) -> Optional[NodeId]:
        avail = [v for v in views if _has_available(v, demand)]
        if avail:
            ordered = sorted(
                avail,
                key=lambda v: (
                    _utilization(v) >= self.spread_threshold,  # under-threshold first
                    _utilization(v),
                    v.node_id != local_node_id,  # prefer local among ties
                    v.node_id.hex(),
                ),
            )
            # pack: among under-threshold nodes prefer the *most* utilized
            under = [v for v in ordered if _utilization(v) < self.spread_threshold]
            if under:
                return max(under, key=lambda v: (_utilization(v), v.node_id == local_node_id)).node_id
            return ordered[0].node_id
        feas = [v for v in views if _feasible(v, demand)]
        if feas:
            # infeasible now but possible later: queue on least loaded feasible node
            return min(feas, key=_utilization).node_id
        return None

    def _spread(self, views: List[NodeView], demand: ResourceSet) -> Optional[NodeId]:
        avail = [v for v in views if _has_available(v, demand)]
        pool = avail or [v for v in views if _feasible(v, demand)]
        if not pool:
            return None
        pool = sorted(pool, key=lambda v: v.node_id.hex())
        self._rr_counter += 1
        return pool[self._rr_counter % len(pool)].node_id

    # -- placement-group bundle packing (ref: bundle_scheduling_policy.cc) -----

    def pick_bundle_nodes(
        self,
        views: List[NodeView],
        bundles: List[ResourceSet],
        strategy: str,
    ) -> Optional[List[NodeId]]:
        """Return one node per bundle, or None if unschedulable."""
        views = [v for v in views if v.alive]
        remaining = {v.node_id: dict(v.available) for v in views}

        def fits(nid, bundle):
            return res_ge(remaining[nid], bundle)

        def take(nid, bundle):
            remaining[nid] = res_sub(remaining[nid], bundle)

        order = sorted(views, key=lambda v: v.node_id.hex())
        result: List[NodeId] = []
        if strategy in ("STRICT_PACK",):
            for v in order:
                if all(res_ge_acc(remaining[v.node_id], bundles)):
                    return [v.node_id] * len(bundles)
            # try exact accumulation per node
            for v in order:
                acc = dict(remaining[v.node_id])
                ok = True
                for b in bundles:
                    if not res_ge(acc, b):
                        ok = False
                        break
                    acc = res_sub(acc, b)
                if ok:
                    return [v.node_id] * len(bundles)
            return None
        if strategy == "STRICT_SPREAD":
            used_nodes = set()
            placed_strict: List[Optional[NodeId]] = [None] * len(bundles)
            # place largest bundles first, but keep bundle-index alignment
            for i, b in sorted(enumerate(bundles), key=lambda kv: -sum(kv[1].values())):
                cand = [v for v in order
                        if v.node_id not in used_nodes and fits(v.node_id, b)]
                if not cand:
                    return None
                nid = cand[0].node_id
                used_nodes.add(nid)
                take(nid, b)
                placed_strict[i] = nid
            return placed_strict  # type: ignore[return-value]
        # PACK (best-effort pack) / SPREAD (best-effort spread)
        prefer_spread = strategy == "SPREAD"
        placed: List[Optional[NodeId]] = [None] * len(bundles)
        for i, b in sorted(enumerate(bundles), key=lambda kv: -sum(kv[1].values())):
            cand = [v for v in order if fits(v.node_id, b)]
            if not cand:
                return None
            if prefer_spread:
                counts = {v.node_id: sum(1 for p in placed if p == v.node_id) for v in cand}
                nid = min(cand, key=lambda v: (counts[v.node_id], v.node_id.hex())).node_id
            else:
                counts = {v.node_id: sum(1 for p in placed if p == v.node_id) for v in cand}
                nid = max(cand, key=lambda v: (counts[v.node_id], -int(v.node_id.hex(), 16) % 997)).node_id
            placed[i] = nid
            take(nid, b)
        return placed  # type: ignore[return-value]


def res_ge_acc(avail: ResourceSet, bundles: List[ResourceSet]):
    acc = dict(avail)
    for b in bundles:
        yield res_ge(acc, b)
        acc = res_sub(acc, b)
