"""Scheduling strategy objects (ref: python/ray/util/scheduling_strategies.py)."""
from __future__ import annotations

from typing import Optional

from ..core.ids import NodeId
from ..core.placement_group import PlacementGroup
from ..core.task_spec import SchedulingStrategy


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        if isinstance(node_id, str):
            node_id = NodeId.from_hex(node_id)
        self.node_id = node_id
        self.soft = soft

    def to_spec(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=self.node_id,
                                  soft=self.soft)


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_spec(self) -> SchedulingStrategy:
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=self.placement_group.id,
            bundle_index=self.placement_group_bundle_index)
