"""ActorPool: balance tasks across a fixed set of actors
(ref: python/ray/util/actor_pool.py)."""

from __future__ import annotations

from collections import deque


def _art():
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    return art


class _Slot:
    """One submitted task: queued until an actor frees, then in flight."""

    __slots__ = ("fn", "value", "ref", "actor")

    def __init__(self, fn, value):
        self.fn = fn
        self.value = value
        self.ref = None
        self.actor = None


class ActorPool:
    def __init__(self, actors):
        self._idle = list(actors)
        self._slots: deque[_Slot] = deque()   # submission order

    # ---- internals

    def _start_queued(self):
        for slot in self._slots:
            if not self._idle:
                break
            if slot.ref is None:
                slot.actor = self._idle.pop(0)
                slot.ref = slot.fn(slot.actor, slot.value)

    def _inflight(self):
        return [s for s in self._slots if s.ref is not None]

    def _free(self, slot: _Slot):
        self._idle.append(slot.actor)
        slot.actor = None
        self._start_queued()

    def _wait_one(self, timeout):
        """Block until some in-flight task finishes; free its actor."""
        art = _art()
        inflight = self._inflight()
        if not inflight:
            raise RuntimeError("pool wedged: queued work, no actors")
        done, _ = art.wait([s.ref for s in inflight], num_returns=1,
                           timeout=timeout)
        if not done:
            raise TimeoutError("no task finished within timeout")
        return done[0]

    # ---- public (ref surface)

    def submit(self, fn, value):
        """fn(actor, value) -> ObjectRef; starts when an actor is free."""
        self._slots.append(_Slot(fn, value))
        self._start_queued()

    def has_next(self) -> bool:
        return bool(self._slots)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: float | None = None):
        """Next result in submission order."""
        if not self._slots:
            raise StopIteration("no pending results")
        art = _art()
        head = self._slots[0]
        while head.ref is None:
            self._wait_one(timeout)  # frees an actor eventually…
            # …but only collection frees it in our accounting, so reap:
            self._start_queued()
            if head.ref is None:
                # head still queued: collect some finished slot's actor
                for slot in list(self._slots):
                    if slot.ref is not None and slot is not head:
                        ready, _ = art.wait([slot.ref], num_returns=1,
                                            timeout=0)
                        if ready:
                            # leave its value for its own get_next; just
                            # recycle the actor
                            if slot.actor is not None:
                                self._free(slot)
                            break
        self._slots.popleft()
        value = art.get(head.ref, timeout=timeout)
        if head.actor is not None:
            self._free(head)
        return value

    def get_next_unordered(self, timeout: float | None = None):
        """Next completed result, any order."""
        if not self._slots:
            raise StopIteration("no pending results")
        art = _art()
        self._start_queued()
        ref = self._wait_one(timeout)
        for slot in self._slots:
            if slot.ref is ref:
                self._slots.remove(slot)
                value = art.get(ref, timeout=timeout)
                if slot.actor is not None:
                    self._free(slot)
                return value
        raise AssertionError("completed ref not in pool")

    def map(self, fn, values):
        """Ordered map over the pool (generator of results)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
