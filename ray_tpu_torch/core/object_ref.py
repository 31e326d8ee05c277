"""ObjectRef: a future-like handle to an object in the cluster.

Equivalent of the reference's ObjectRef (ref: python/ray/_raylet.pyx ObjectRef
cdef class; ownership semantics per src/ray/core_worker/reference_count.h:61 —
every ref carries its owner's identity so borrowers can locate the value and
report their references)."""
from __future__ import annotations

from typing import Optional

from .ids import ObjectId, TaskId, WorkerId


# Per-process hook invoked for every ObjectRef materialized by
# DESERIALIZATION (not plain construction). Workers install it to report
# borrowed references to the head; the driver installs it to count refs it
# receives inside fetched values (ref: _private/serialization.py in-band
# ObjectRef tracking for the borrowing protocol).
_borrow_hook = None


def _set_borrow_hook(hook) -> None:
    global _borrow_hook
    _borrow_hook = hook


def _reconstruct_ref(object_id, owner, call_site):
    ref = ObjectRef(object_id, owner, call_site)
    hook = _borrow_hook
    if hook is not None:
        try:
            hook(ref)
        except Exception:
            pass
    return ref


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded items
    (ref: python/ray/_raylet.pyx ObjectRefGenerator /
    core_worker.proto:436). Each __next__ blocks until the worker reports
    the next item, then returns an ObjectRef to it. Usable in the process
    that submitted the task."""

    def __init__(self, task_id, runtime):
        import weakref

        self._task_id = task_id
        self._rt = runtime
        self._index = 0
        # free never-consumed items when the generator is dropped
        weakref.finalize(self, runtime.release_generator, task_id)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self, timeout: Optional[float] = None):
        """`__next__` with a deadline: raises GetTimeoutError if the
        producer yields nothing within `timeout` seconds. Lets blocking
        consumers (Serve proxies) bound how long a hung replica can pin
        their thread."""
        ref = self._rt.next_generator_item(self._task_id, self._index,
                                           timeout=timeout)
        if ref is None:
            raise StopIteration
        self._index += 1
        return ref

    def completed(self) -> int:
        """Items consumed so far."""
        return self._index

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:12]}, i={self._index})"


class ObjectRef:
    __slots__ = ("id", "owner", "_call_site", "__weakref__")

    def __init__(self, object_id: ObjectId, owner: Optional[WorkerId] = None,
                 call_site: str = ""):
        self.id = object_id
        self.owner = owner
        self._call_site = call_site

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self) -> bytes:
        return self.id.task_prefix()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        # Serialization of a ref hands out a *borrowed* reference; the
        # deserializing process's _borrow_hook reports the borrow so the
        # head's per-holder counts keep the object alive.
        return (_reconstruct_ref, (self.id, self.owner, self._call_site))

    # Allow `await ref` inside async actors.
    def __await__(self):
        from . import runtime

        result = yield from runtime.get_runtime().get_async(self).__await__()
        return result

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from . import runtime

        return runtime.get_runtime().as_future(self)
