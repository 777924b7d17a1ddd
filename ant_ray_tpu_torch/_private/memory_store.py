"""In-process memory store for owned objects (ref:
src/ray/core_worker/store_provider/memory_store/).

Entries hold the terminal state of every object this process owns:
    ("pending", None)          — task not finished / value not produced yet
    ("inline", payload)        — small object, serialized payload held here
    ("error", payload)         — serialized exception (raised at get)
    ("plasma", size)           — large object, lives in the shm object plane

Thread-safe producers; consumers wait either synchronously (app threads) or
asynchronously (io-loop handlers serving borrower GetObject RPCs).
"""

from __future__ import annotations

import asyncio

from ant_ray_tpu_torch._lint.lockcheck import make_rlock
from ant_ray_tpu_torch._private.ids import ObjectID


class MemoryStore:
    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._entries: dict[ObjectID, tuple] = {}
        self._async_waiters: dict[ObjectID, list[asyncio.Future]] = {}
        # Any-change subscription (io-loop side): WaitObjects long-polls
        # park here and are woken by EVERY terminal put, so one parked
        # reply covers a whole batch of refs without per-ref futures.
        self._change_waiters: list[asyncio.Future] = []
        # REENTRANT: any allocation inside the critical sections can
        # trigger GC, which may run ObjectRef.__del__ -> _refcount_event
        # -> is_owned() on the SAME thread — a plain Lock self-deadlocks
        # the io loop there (observed via create_future inside
        # wait_async; the same class of bug as the reference-counter
        # RLock in core.py).
        self._lock = make_rlock("memory_store")

    def mark_pending(self, object_id: ObjectID) -> None:
        with self._lock:
            self._entries.setdefault(object_id, ("pending", None))

    def put(self, object_id: ObjectID, kind: str, value) -> None:
        assert kind in ("inline", "error", "plasma"), kind
        with self._lock:
            self._entries[object_id] = (kind, value)
            waiters = self._async_waiters.pop(object_id, [])
            change_waiters, self._change_waiters = \
                self._change_waiters, []
        for fut in waiters:
            self._loop.call_soon_threadsafe(self._resolve, fut, (kind, value))
        for fut in change_waiters:
            self._loop.call_soon_threadsafe(self._resolve, fut, True)

    @staticmethod
    def _resolve(fut: asyncio.Future, entry: tuple) -> None:
        if not fut.done():
            fut.set_result(entry)

    def get_entry(self, object_id: ObjectID) -> tuple | None:
        with self._lock:
            return self._entries.get(object_id)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry[0] != "pending"

    def is_owned(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    async def wait_async(self, object_id: ObjectID,
                         timeout: float | None = None) -> tuple:
        """Await a terminal entry (must run on the io loop)."""
        # Allocate the future OUTSIDE the lock: create_future can GC
        # (see the RLock note above) and fewer allocation points inside
        # the critical section means fewer reentrant excursions.
        fut = self._loop.create_future()
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry[0] != "pending":
                return entry
            self._async_waiters.setdefault(object_id, []).append(fut)
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            # Abandoned waiter (timed-out wait_for / cancelled wait()
            # task): remove it NOW — a long-pending object polled in a
            # loop would otherwise accumulate one dead future per call
            # until its eventual put().
            with self._lock:
                waiters = self._async_waiters.get(object_id)
                if waiters is not None:
                    try:
                        waiters.remove(fut)
                    except ValueError:
                        pass
                    if not waiters:
                        del self._async_waiters[object_id]
            raise

    def change_future(self) -> asyncio.Future:
        """Register a future resolved on the NEXT terminal put.  Long
        pollers register BEFORE snapshotting entries, so a cross-thread
        put between snapshot and park can never be missed."""
        fut = self._loop.create_future()
        with self._lock:
            self._change_waiters.append(fut)
        return fut

    def discard_change_future(self, fut: asyncio.Future) -> None:
        with self._lock:
            try:
                self._change_waiters.remove(fut)
            except ValueError:
                pass

    async def wait_change(self, timeout: float,
                          fut: asyncio.Future | None = None) -> bool:
        """Park until ANY object turns terminal (or timeout); returns
        whether a change fired.  Must run on the io loop."""
        if fut is None:
            fut = self.change_future()
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            self.discard_change_future(fut)
            return False

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._entries.pop(object_id, None)
            waiters = self._async_waiters.pop(object_id, [])
        for fut in waiters:
            self._loop.call_soon_threadsafe(
                lambda f=fut: f.cancel() if not f.done() else None)
