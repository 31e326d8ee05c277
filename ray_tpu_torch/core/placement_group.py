"""Placement groups — gang resource reservation with 2-phase commit.

Equivalent of the reference's placement group API
(ref: python/ray/util/placement_group.py:139 placement_group();
GCS manager + 2PC in src/ray/gcs/gcs_server/gcs_placement_group_manager.cc,
raylet side src/ray/raylet/placement_group_resource_manager.cc).

TPU-native note: bundles may request `TPU` and carry a `tpu_slice` label so a
STRICT_SPREAD group maps one bundle per pod host — this is how MeshGroup gang
schedules its per-host workers (ray_tpu_torch/parallel/mesh_group.py)."""
from __future__ import annotations

from typing import Dict, List, Optional

from . import runtime as runtime_mod
from .ids import PlacementGroupId


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupId, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self, timeout: float = 30.0) -> bool:
        rt = runtime_mod.get_runtime()
        return rt.pg_ready(self.id, timeout)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout_seconds)

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
        raise ValueError(f"Invalid placement strategy {strategy!r}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    rt = runtime_mod.get_runtime()
    pg_id = rt.create_placement_group(bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    rt = runtime_mod.get_runtime()
    rt.remove_placement_group(pg.id)


def placement_group_table() -> List[dict]:
    rt = runtime_mod.get_runtime()
    if not hasattr(rt, "gcs"):
        raise RuntimeError("placement_group_table is driver-only")
    return [
        {"placement_group_id": i.pg_id.hex(), "state": i.state,
         "strategy": i.strategy, "bundles": i.bundles, "name": i.name}
        for i in rt.gcs.list_pgs()
    ]
