"""KV-session offload store for the LLM engine (a copy of the host tier
of ant_ray_tpu/llm/kv_offload.py, which the port does not import).

When the engine evicts an idle session (``kv_idle_evict_s`` LRU sweep or
KV-full admission pressure), it copies the session's per-slot KV slab to
host memory and hands it to a store; on the session's next token the
slab is fetched back (on a background thread — the engine step loop
never blocks on a restore) and re-installed into a free slot.  A slab
is ``(k, v, length)`` with k and v CPU ``torch.Tensor``s (bf16 has no
numpy dtype) and length an int.  Pickling tensors is bitwise exact, so
a spilled slab comes back bit for bit.

:class:`LocalKvStore` keeps slabs in process memory, optionally
spilling the least recently put ones to files under ``spill_dir``; it
moves the capacity bound from device memory to host RAM (or disk).  The
reference's object-plane tier (``ObjectPlaneKvStore``, ``KvVault``)
needs the runtime, which the port does not have yet.
"""

from __future__ import annotations

import itertools
import os
import pickle
import threading
from typing import Any


class KvStoreError(RuntimeError):
    """Typed wrapper: a slab put/get against the backing tier failed."""


class LocalKvStore:
    """Host-memory (optionally file-spilled) slab store.

    ``capacity_slabs`` bounds the in-memory tier; beyond it the least
    recently PUT slab spills to ``spill_dir`` (created lazily).  With
    ``spill_dir=None`` everything stays in the dict — fine for tests.
    """

    def __init__(self, spill_dir: str | None = None,
                 capacity_slabs: int | None = None):
        self._mem: dict[str, Any] = {}       # in-memory slabs only
        self._paths: dict[str, str] = {}     # key -> spill file
        self._order: list[str] = []          # LRU by put time
        self._spill_dir = spill_dir
        self._capacity = capacity_slabs
        # Spill files are named by a monotonic counter, never by
        # hash(key): colliding hashes would silently hand one session
        # another session's bytes.
        self._spill_seq = itertools.count()
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0
        self.spills = 0

    def put(self, key: str, slab) -> str:
        with self._lock:
            self.puts += 1
            self._mem[key] = slab
            stale = self._paths.pop(key, None)  # superseded spill file
            if key in self._order:
                self._order.remove(key)
            self._order.append(key)
            # _mem holds only real slabs (spill paths live in _paths),
            # so the capacity check counts exactly capacity_slabs.
            if (self._capacity is not None and self._spill_dir
                    and len(self._mem) > self._capacity):
                victim = self._order.pop(0)
                self._spill(victim, self._mem.pop(victim))
        if stale:
            try:
                os.unlink(stale)
            except OSError:
                pass
        return key

    def _spill(self, key: str, slab):
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir,
                            f"kv-{next(self._spill_seq)}.bin")
        with open(path, "wb") as f:
            pickle.dump(slab, f, protocol=pickle.HIGHEST_PROTOCOL)
        self._paths[key] = path
        self.spills += 1

    def get(self, handle: str):
        with self._lock:
            self.gets += 1
            if handle in self._mem:
                return self._mem[handle]
            path = self._paths.get(handle)
        if path is None:
            raise KvStoreError(f"no slab for session {handle!r}")
        with open(path, "rb") as f:
            return pickle.load(f)   # a file this store wrote

    def delete(self, handle: str):
        with self._lock:
            self._mem.pop(handle, None)
            path = self._paths.pop(handle, None)
            if handle in self._order:
                self._order.remove(handle)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass
