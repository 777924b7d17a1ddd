"""ObjectRef: a future handle to a value in the distributed object plane.

Semantics follow the reference's ObjectRef (ref: python/ray/includes/object_ref.pxi):
refs are owned by the process that created them, are first-class serializable
values (serializing a ref inside another object registers a borrow with the
ownership layer), and release their reference count on garbage collection.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ant_ray_tpu_torch._private import serialization
from ant_ray_tpu_torch._private.ids import ObjectID

if TYPE_CHECKING:
    pass


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "_skip_refcount", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str = "",
                 _skip_refcount: bool = False):
        self._id = object_id
        self._owner_address = owner_address
        self._skip_refcount = _skip_refcount
        if not _skip_refcount:
            _refcount_hook("add", self)

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner_address(self) -> str:
        return self._owner_address

    def task_id(self):
        return self._id.task_id()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        serialization.record_contained_ref(self)
        return (_deserialize_ref, (self._id, self._owner_address))

    def __del__(self):
        if not self._skip_refcount:
            try:
                _refcount_hook("remove", self)
            except Exception:
                pass

    # Allow `await ref` inside async actors.
    def __await__(self):
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        return global_worker.get_async(self).__await__()


def _deserialize_ref(object_id: ObjectID, owner_address: str) -> ObjectRef:
    ref = ObjectRef(object_id, owner_address, _skip_refcount=True)
    _refcount_hook("deserialized", ref)
    # The "deserialized" event is the add; re-enable __del__ accounting so
    # the borrow is released when this ref is GC'd.
    ref._skip_refcount = False
    return ref


def _noop_hook(event: str, ref: ObjectRef) -> None:
    pass


_refcount_hook = _noop_hook


def set_refcount_hook(hook) -> None:
    """Installed by the core runtime to observe ref creation/destruction."""
    global _refcount_hook
    _refcount_hook = hook if hook is not None else _noop_hook


class ObjectRefGenerator:
    """Stream of ObjectRefs from a ``num_returns="streaming"`` task
    (ref: ObjectRefStream, src/ray/core_worker/task_manager.h:67 and the
    ObjectRefGenerator surface in python/ray/_raylet.pyx).

    Yields each return's ObjectRef AS IT IS PRODUCED by the still-running
    task — the consumer can ``get()`` the first item long before the
    producer finishes.  Iteration blocks on the next item; ``StopIteration``
    once the producer signalled the end of the stream; a mid-stream task
    failure raises at the failure point after all prior items."""

    def __init__(self, task_id, runtime):
        self._task_id = task_id
        self._runtime = runtime
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self):
        ref = self._runtime.stream_next(self._task_id, self._index, None)
        if ref is None:
            raise StopIteration
        self._index += 1
        return ref

    def next_with_timeout(self, timeout: float | None):
        """Like next() but bounded; raises GetTimeoutError on deadline."""
        ref = self._runtime.stream_next(self._task_id, self._index,
                                        timeout)
        if ref is None:
            raise StopIteration
        self._index += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio  # noqa: PLC0415

        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration from None

    @property
    def task_id(self):
        return self._task_id

    def __del__(self):
        try:
            self._runtime.release_stream(self._task_id, self._index)
        except Exception:  # noqa: BLE001 — interpreter shutdown etc.
            pass
