"""Resource-set algebra.

Equivalent of the reference's scheduling primitives
(ref: src/ray/common/scheduling/cluster_resource_data.h NodeResources /
ResourceRequest; fixed_point.h). Floating resources are kept as floats with an
epsilon — the fixed-point trick is unnecessary at this scale. `TPU` and
`tpu_slice` are first-class resource names so the scheduler can gang-place
mesh workers onto slice topologies.
"""
from __future__ import annotations

from typing import Dict

EPS = 1e-9

ResourceSet = Dict[str, float]


def res_add(a: ResourceSet, b: ResourceSet) -> ResourceSet:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def res_sub(a: ResourceSet, b: ResourceSet) -> ResourceSet:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def res_ge(a: ResourceSet, b: ResourceSet) -> bool:
    """a >= b elementwise (a can satisfy demand b)."""
    for k, v in b.items():
        if v > EPS and a.get(k, 0.0) + EPS < v:
            return False
    return True


def res_nonneg(a: ResourceSet) -> bool:
    return all(v >= -EPS for v in a.values())


def normalize(a: ResourceSet) -> ResourceSet:
    return {k: float(v) for k, v in a.items() if abs(v) > EPS}
