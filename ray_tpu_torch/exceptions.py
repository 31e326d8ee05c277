"""User-visible exceptions.

Mirrors the reference's exception taxonomy (ref: python/ray/exceptions.py):
task errors wrap the remote traceback; actor/object/worker failures are
distinct types so application code can catch them specifically.
"""
from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception. Holds the remote traceback and
    re-raises with ``cause`` preserved where possible."""

    def __init__(self, cause: BaseException | None = None, remote_traceback: str = "",
                 task_desc: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_desc = task_desc
        super().__init__(str(self))

    def __str__(self):
        msg = f"Task failed: {self.task_desc}\n{self.remote_traceback}"
        if self.cause is not None:
            msg += f"\nCaused by: {type(self.cause).__name__}: {self.cause}"
        return msg

    @classmethod
    def from_exception(cls, exc: BaseException, task_desc: str = "") -> "TaskError":
        return cls(cause=exc, remote_traceback=traceback.format_exc(), task_desc=task_desc)


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead (creation failed, exited, or its node died) and will
    not be restarted (restarts exhausted)."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """The object's value was lost and could not be reconstructed."""

    def __init__(self, object_id_hex: str, msg: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(msg or f"Object {object_id_hex} was lost and could not be recovered.")


class OwnerDiedError(ObjectLostError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class CompiledGraphError(RayTpuError):
    """Base class for compiled-graph (ray_tpu_torch.cgraph) failures."""


class CompiledGraphClosedError(CompiledGraphError):
    """The compiled graph was torn down (explicitly, or because a
    participating actor or channel peer died) while executions were in
    flight; every pending ``execute()`` ref raises this."""


class ChannelFullError(CompiledGraphError):
    """A compiled-graph channel write could not complete: the payload
    exceeds the channel's pre-allocated slot capacity."""


class DataFeedError(CompiledGraphError):
    """A data-feed pump actor (ray_tpu_torch/data/feed.py) attached to a
    pipeline engine died or failed while the engine was live; the engine
    aborts with this so ``recover()`` can respawn the stages AND
    re-attach the feed."""
