"""Tiered KV-session offload stores for the LLM engine (a copy of
ant_ray_tpu/llm/kv_offload.py, which the port does not import).

When the engine evicts an idle session (``kv_idle_evict_s`` LRU sweep or
KV-full admission pressure), it copies the session's per-slot KV slab to
host memory and hands it to one of these stores; on the session's next
token the slab is fetched back (on a background thread — the engine
step loop never blocks on a restore) and re-installed into a free slot.
A slab is ``(k, v, length)`` with k and v CPU ``torch.Tensor``s (bf16
has no numpy dtype) and length an int.  The round trip is bitwise exact,
so restored sessions' token streams are identical to uninterrupted runs.

Two tiers:

* :class:`LocalKvStore` — in-process host memory (optionally spilling
  each slab to a file under ``spill_dir``; pickling tensors is bitwise
  exact).  No cluster required; this is the standalone-engine /
  unit-test tier, and already moves the capacity bound from device
  memory to host RAM (or disk with ``spill_dir``).
* :class:`ObjectPlaneKvStore` — seals slabs into the object store via
  plain ``art.put`` (the serializer sends each tensor's bytes out of
  band into the node's shared-memory arena, with its arena → spill
  tiers and seal/pin machinery as they are), making resident-session
  count a DISK-bounded number.  ``get`` rebuilds the tensors from the
  arena: they own their memory, so dropping the ref (``delete``) never
  frees bytes a pending install still reads.  With ``vault`` set to an
  actor handle, slabs live on the vault's node instead and restores
  travel the bulk channel — which is also what lets chaos tests kill
  the holder mid-restore.
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


class ObjectPlaneKvStore:
    """Slabs live in the distributed object store.

    put → ``art.put`` (local arena create/seal; the store's own
    arena → spill tiering makes cold slabs disk-resident for free);
    get → ``art.get``.  Dropping the ref on delete lets refcount GC
    reclaim the bytes.

    ``vault``: an actor handle with ``put(key, slab)`` / ``fetch(key)``
    / ``drop(key)`` methods (see :class:`KvVault`).  Slabs then resolve
    on the vault's node and every restore is a cross-node bulk-channel
    pull — the deployment shape for engines whose own node has no disk
    headroom, and the seam chaos tests use to kill a holder
    mid-restore.

    ``get_timeout_s`` bounds a restore so a dead holder fails the ONE
    session typed instead of wedging its restore thread forever.

    The store holds the runtime module and a lock, so it does not
    pickle: a Serve replica builds its own from ``kv_offload="object"``
    or ``"auto"``.
    """

    def __init__(self, vault=None, get_timeout_s: float = 30.0):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        self._art = art
        self._vault = vault
        self._timeout = get_timeout_s
        self._refs: dict[str, Any] = {}
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0

    def put(self, key: str, slab) -> str:
        self.puts += 1
        if self._vault is not None:
            self._art.get(self._vault.put.remote(key, slab),
                          timeout=self._timeout)
        else:
            ref = self._art.put(slab)
            with self._lock:
                self._refs[key] = ref
        return key

    def get(self, handle: str):
        self.gets += 1
        if self._vault is not None:
            return self._art.get(self._vault.fetch.remote(handle),
                                 timeout=self._timeout)
        with self._lock:
            ref = self._refs.get(handle)
        if ref is None:
            raise KvStoreError(f"no slab ref for session {handle!r}")
        return self._art.get(ref, timeout=self._timeout)

    def delete(self, handle: str):
        if self._vault is not None:
            try:
                self._vault.drop.remote(handle)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            return
        with self._lock:
            self._refs.pop(handle, None)


class KvVault:
    """Remote slab holder: place with ``art.remote(KvVault).options(...)``
    on the node that should own evicted sessions' bytes.  Fetches return
    the slab through the normal large-return path (object store +
    chunked bulk pull), so `testing_chunk_serve_delay_s` and holder
    chaos apply to restores exactly as to any other object read."""

    def __init__(self):
        self._slabs: dict[str, Any] = {}

    def put(self, key: str, slab):
        self._slabs[key] = slab
        return True

    def fetch(self, key: str):
        if key not in self._slabs:
            raise KvStoreError(f"vault has no slab {key!r}")
        return self._slabs[key]

    def drop(self, key: str):
        self._slabs.pop(key, None)
        return True
