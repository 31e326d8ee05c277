"""Task specification — the unit handed from submitter to scheduler to worker.

Equivalent of the reference's TaskSpecification
(ref: src/ray/common/task/task_spec.h; protobuf common.proto TaskSpec).
Args follow the reference's inlining rule: top-level ObjectRef args are
resolved by the executing worker; plain values ≤ the inline threshold travel
inside the spec, larger ones are promoted to the object store by the caller.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorId, JobId, NodeId, ObjectId, PlacementGroupId, TaskId, WorkerId
from .object_ref import ObjectRef


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


# An argument is either an inline serialized value or a reference.
ARG_VALUE = 0
ARG_REF = 1
Arg = Tuple[int, Any]  # (ARG_VALUE, bytes) | (ARG_REF, ObjectRef)

# num_returns sentinel: the task is a generator streaming items back one
# at a time (ref: src/ray/protobuf/core_worker.proto:436
# ReportGeneratorItemReturns; num_returns="streaming")
STREAMING_RETURNS = -1


@dataclass
class SchedulingStrategy:
    """DEFAULT / SPREAD / node affinity / placement group.
    (ref: python/ray/util/scheduling_strategies.py)"""

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Optional[NodeId] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupId] = None
    bundle_index: int = -1  # -1 = any bundle


@dataclass
class TaskSpec:
    task_id: TaskId
    job_id: JobId
    task_type: TaskType
    func_id: str  # key into the GCS function table
    description: str  # human-readable fn/actor.method name
    args: List[Arg]
    kwargs: Dict[str, Arg]
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    # direct dispatch: the submitting process's worker id = the actor
    # queue LANE this task is sequenced in (None = head-routed lane).
    # Per-caller FIFO is the ordering contract (ref:
    # direct_actor_task_submitter.h client-side sequencing); seq_no
    # counts within the lane.
    owner_id: Optional[WorkerId] = None
    # actor fields
    actor_id: Optional[ActorId] = None
    method_name: str = ""
    seq_no: int = 0  # client-side ordering for actor tasks
    max_restarts: int = 0
    max_concurrency: int = 1
    concurrency_group: str = ""
    # creation-task only: named group -> max concurrent calls
    # (ref: src/ray/core_worker/transport/concurrency_group_manager.cc)
    concurrency_groups: Optional[Dict[str, int]] = None
    is_async_actor: bool = False
    runtime_env: Optional[dict] = None
    # distributed tracing: (trace_id, parent_span_id) propagated from the
    # submitting context (ref: python/ray/util/tracing/ — the OTel
    # context-injection hooks; here spans ride the spec and land in the
    # GCS task-event stream)
    trace_ctx: Optional[tuple] = None

    def return_ids(self) -> List[ObjectId]:
        # STREAMING_RETURNS (-1): ids are minted per yielded item instead.
        # Memoized per task_id: the submit path asks three times per
        # task. The cache is keyed on the id because actor restart
        # copy.copy()s the creation spec and reassigns task_id — a bare
        # memo would hand the restarted task the ORIGINAL return ids.
        cached = self.__dict__.get("_rids")
        if cached is not None and cached[0] is self.task_id:
            return cached[1]
        rids = [ObjectId.for_task_return(self.task_id, i)
                for i in range(self.num_returns)]
        self.__dict__["_rids"] = (self.task_id, rids)
        return rids

    def arg_refs(self) -> List[ObjectRef]:
        refs = [a[1] for a in self.args if a[0] == ARG_REF]
        refs += [a[1] for a in self.kwargs.values() if a[0] == ARG_REF]
        return refs
