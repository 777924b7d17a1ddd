"""Distributed FIFO queue backed by an actor
(ref: python/ray/util/queue.py)."""

from __future__ import annotations

import asyncio


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout=None):
        try:
            await asyncio.wait_for(self._queue.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full from None
        return True

    async def get(self, timeout=None):
        try:
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty from None

    async def put_nowait(self, item):
        try:
            self._queue.put_nowait(item)
        except asyncio.QueueFull:
            raise Full from None
        return True

    async def get_nowait(self):
        try:
            return self._queue.get_nowait()
        except asyncio.QueueEmpty:
            raise Empty from None

    async def qsize(self):
        return self._queue.qsize()

    async def empty(self):
        return self._queue.empty()

    async def full(self):
        return self._queue.full()


def _unwrap(call):
    """Re-raise the actor's Empty/Full as the local exception class
    (the framework wraps app errors in ActorError with a cause chain)."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001
        cause = getattr(e, "cause", None)
        if isinstance(cause, Empty) or type(cause).__name__ == "Empty":
            raise Empty from None
        if isinstance(cause, Full) or type(cause).__name__ == "Full":
            raise Full from None
        raise


class Queue:
    """Driver/worker-shared queue; the payload lives in one actor, so
    producers and consumers anywhere in the cluster see one FIFO."""

    def __init__(self, maxsize: int = 0, *, actor_options: dict | None =
                 None):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 16)
        opts.setdefault("num_cpus", 0)
        self._actor = art.remote(_QueueActor).options(**opts).remote(
            maxsize)

    def put(self, item, block: bool = True, timeout: float | None = None):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        if not block:
            return _unwrap(
                lambda: art.get(self._actor.put_nowait.remote(item)))
        return _unwrap(
            lambda: art.get(self._actor.put.remote(item, timeout)))

    def get(self, block: bool = True, timeout: float | None = None):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        if not block:
            return _unwrap(
                lambda: art.get(self._actor.get_nowait.remote()))
        return _unwrap(lambda: art.get(
            self._actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 10))

    def qsize(self) -> int:
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        return art.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        return art.get(self._actor.empty.remote())

    def full(self) -> bool:
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        return art.get(self._actor.full.remote())

    def shutdown(self):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        art.kill(self._actor)
