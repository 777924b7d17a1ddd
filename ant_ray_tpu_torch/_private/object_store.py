"""Node-local shared-memory object store ("plasma"-equivalent).

Role of the reference's plasma store (ref: src/ray/object_manager/plasma/
store.h:55, obj_lifecycle_mgr.h, eviction_policy.h), redesigned: each object
is one file in a tmpfs session directory (/dev/shm on Linux), mmap'd by
readers for zero-copy access.  The node daemon owns the store; clients in
worker/driver processes open the files directly by path, so a local `get`
never copies through an RPC.  Pinning + LRU eviction of unpinned objects;
capacity enforcement with create-backpressure left to the node daemon.

Why files instead of multiprocessing.shared_memory: named SharedMemory
segments are entangled with the resource tracker (which unlinks segments
when their creating process exits); plain tmpfs files have exactly the
lifetime we manage, and POSIX keeps mappings valid after unlink so readers
holding an mmap survive eviction.
"""

from __future__ import annotations

import logging
import mmap
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ant_ray_tpu_torch._lint.lockcheck import make_lock, make_rlock
from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.ids import ObjectID
from ant_ray_tpu_torch.exceptions import ObjectLostError

logger = logging.getLogger(__name__)


@dataclass
class ObjectEntry:
    object_id: ObjectID
    size: int
    # Read pins, addressed by caller-unique tokens (the daemon's pin-lease
    # tokens): token-addressing lets an unpin land on exactly the entry
    # generation it pinned, even after the id was deleted and re-created
    # (lineage reconstruction re-stores under the same id).
    pin_tokens: set = field(default_factory=set)
    sealed: bool = False
    offset: int | None = None       # arena payload offset (native mode)
    created_at: float = field(default_factory=time.monotonic)

    @property
    def pin_count(self) -> int:
        return len(self.pin_tokens)


ARENA_FILENAME = "arena.buf"


class ObjectStore:
    """Node-side store: tracks entries, capacity, pins, and LRU eviction.

    Two storage backends share the bookkeeping:
    * **arena** (preferred): one mmap'd tmpfs file managed by the C++
      boundary-tag allocator (native/store_core.cpp) — objects are
      [offset, size) windows, created by granting write buffers to
      colocated producers (plasma's create→seal protocol).
    * **file-per-object** fallback when the native extension is
      unavailable.
    """

    def __init__(self, directory: str, capacity_bytes: int,
                 use_arena: bool = True, on_delete=None,
                 spill_dir: str | None = None):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._capacity = capacity_bytes
        self._used = 0
        # Called (outside no lock guarantees — keep it cheap/thread-safe)
        # with each ObjectID removed by eviction or deletion, so the
        # daemon can retract the node's GCS location record.
        self._on_delete = on_delete
        # Spill-on-evict to disk (ref: LocalObjectManager,
        # local_object_manager.h:44): evicted sealed objects move to
        # spill_dir and restore transparently on next access, so the
        # node keeps serving them and no location retraction happens.
        self._spill_dir = spill_dir
        self._spilled: dict[ObjectID, int] = {}   # oid -> size
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._entries: "OrderedDict[ObjectID, ObjectEntry]" = OrderedDict()
        # Deleted-while-pinned payloads: invisible to lookups, bytes kept
        # allocated until the last read pin drops (see _delete_locked).
        # A list, not a dict: the same object id can be doomed more than
        # once (delete → re-create → delete again, each under pins).
        self._doomed: list[ObjectEntry] = []
        self._lock = make_rlock("object_store.arena")
        self._arena = None
        if use_arena:
            from ant_ray_tpu_torch._private.native import load_native  # noqa: PLC0415

            native = load_native()
            if native is not None:
                self._arena = native.Arena(
                    self.arena_path, capacity=capacity_bytes, create=True)

    @property
    def arena_path(self) -> str:
        return os.path.join(self._dir, ARENA_FILENAME)

    @property
    def uses_arena(self) -> bool:
        return self._arena is not None

    # ---- arena create/seal protocol (native mode)

    def create_buffer(self, object_id: ObjectID, size: int) -> int:
        """Reserve an unsealed write window; returns the payload offset.

        Raises BufferExistsError carrying whether the existing entry is
        sealed, so callers can distinguish idempotent re-put (sealed)
        from an abandoned grant (unsealed → abort and retry)."""
        with self._lock:
            existing = self._entries.get(object_id)
            if existing is not None:
                raise BufferExistsError(object_id, existing.sealed)
            self._ensure_space(size)
            offset = self._arena_alloc(size)
            self._entries[object_id] = ObjectEntry(
                object_id, size, sealed=False, offset=offset)
            self._used += size
            return offset

    def seal_buffer(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                raise ObjectLostError(object_id, "seal of unknown buffer")
            entry.sealed = True

    def abort_buffer(self, object_id: ObjectID) -> None:
        """Drop an unsealed grant (failed pull / crashed producer)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and not entry.sealed:
                self._delete_locked(object_id)

    def grant_age(self, object_id: ObjectID) -> float:
        """Seconds since an *unsealed* grant was created; +inf when the
        entry is missing or sealed.  Lets the daemon distinguish a live
        producer mid-write from a grant orphaned by a crash."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or entry.sealed:
                return float("inf")
            return time.monotonic() - entry.created_at

    def view_unsealed(self, object_id: ObjectID) -> memoryview:
        """Writable view of an unsealed arena grant (daemon-side sink for
        pulls; keeps _arena private to this class)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or entry.sealed or entry.offset is None:
                raise ObjectLostError(object_id, "no unsealed arena grant")
            return self._arena.view(entry.offset, entry.size)

    def _arena_alloc(self, size: int) -> int:
        while True:
            try:
                return self._arena.alloc(max(size, 1))
            except MemoryError:
                # Accounting says it fits but fragmentation bites: evict.
                if not self._evict_one():
                    raise ObjectStoreFullError(
                        "arena fragmented and nothing evictable") from None

    def arena_file_offset(self, payload_offset: int) -> int:
        """Absolute file offset for a payload offset (layout knowledge
        stays on the native side via the heap_start getter)."""
        return self._arena.heap_start + payload_offset

    def locate(self, object_id: ObjectID) -> dict | None:
        """{"path", "offset", "size"} for readers; offset is an absolute
        file offset (None = file-per-object fallback)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None and self._restore_locked(object_id):
                entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return None
            self._entries.move_to_end(object_id)
            if entry.offset is not None:
                return {"path": self.arena_path,
                        "offset": self.arena_file_offset(entry.offset),
                        "size": entry.size}
            return {"path": self.path_of(object_id), "offset": None,
                    "size": entry.size}

    # ---- paths

    def path_of(self, object_id: ObjectID) -> str:
        return os.path.join(self._dir, object_id.hex())

    @property
    def directory(self) -> str:
        return self._dir

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used(self) -> int:
        return self._used

    @property
    def spilled_bytes(self) -> int:
        with self._lock:
            return self._spilled_bytes()

    # ---- write path

    def create(self, object_id: ObjectID, payload: bytes | memoryview) -> str:
        """Write + seal an object; returns the file path.

        Evicts unpinned LRU objects if needed; raises ObjectStoreFullError
        when the payload cannot fit even after eviction.
        """
        size = len(payload)
        with self._lock:
            if object_id in self._entries:
                return self.path_of(object_id)  # idempotent re-put
            self._ensure_space(size)
            if self._arena is not None:
                offset = self._arena_alloc(size)
                self._arena.view(offset, size)[:] = payload
                self._entries[object_id] = ObjectEntry(
                    object_id, size, sealed=True, offset=offset)
                self._used += size
                return self.arena_path
            path = self.path_of(object_id)
            with open(path, "wb") as f:
                f.write(payload)
            self._entries[object_id] = ObjectEntry(object_id, size, sealed=True)
            self._used += size
            return path

    def seal_file(self, object_id: ObjectID, tmp_path: str) -> str:
        """Adopt a fully-written temp file as a sealed object (producer
        fallback path; in arena mode the contents move into the arena)."""
        size = os.path.getsize(tmp_path)
        with self._lock:
            if object_id in self._entries:
                os.unlink(tmp_path)
                return self.path_of(object_id)
            self._ensure_space(size)
            if self._arena is not None:
                offset = self._arena_alloc(size)
                view = self._arena.view(offset, size)
                with open(tmp_path, "rb") as f:
                    f.readinto(view)
                os.unlink(tmp_path)
                self._entries[object_id] = ObjectEntry(
                    object_id, size, sealed=True, offset=offset)
                self._used += size
                return self.arena_path
            final = self.path_of(object_id)
            os.rename(tmp_path, final)
            self._entries[object_id] = ObjectEntry(object_id, size, sealed=True)
            self._used += size
            return final

    def _ensure_space(self, size: int) -> None:
        if size > self._capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity "
                f"{self._capacity}")
        while self._used + size > self._capacity:
            evicted = self._evict_one()
            if not evicted:
                raise ObjectStoreFullError(
                    f"store full ({self._used}/{self._capacity} bytes) and "
                    "all objects pinned")

    def _evict_one(self) -> bool:
        for oid, entry in self._entries.items():
            # Unsealed grants are producer-owned and never evictable —
            # freeing their slot while another process writes through its
            # view would corrupt whatever reuses the memory.
            if entry.pin_count == 0 and entry.sealed:
                if self._spill_dir is not None:
                    self._spill_locked(oid, entry)
                else:
                    self._delete_locked(oid)
                return True
        return False

    def _spill_path(self, object_id: ObjectID) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def _spill_locked(self, object_id: ObjectID, entry: ObjectEntry):
        """Move a sealed object's payload to disk, then drop it from
        memory WITHOUT retracting its location (this node still serves
        it, via restore).

        The disk write happens under the store lock — synchronous-spill
        simplicity traded against the reference's async spill IO
        workers (local_object_manager.h:109); revisit if eviction of
        very large objects shows up on daemon latency."""
        if self._spilled_bytes() + entry.size > \
                global_config().max_spill_bytes:
            logger.warning("spill capacity exhausted; dropping %s",
                           object_id.hex()[:8])
            self._delete_locked(object_id)
            return
        path = self._spill_path(object_id)
        try:
            with open(path, "wb") as f:
                if entry.offset is not None:
                    f.write(self._arena.view(entry.offset, entry.size))
                else:
                    with open(self.path_of(object_id), "rb") as src:
                        f.write(src.read())
        except OSError as e:
            logger.warning("spill of %s failed (%s); dropping",
                           object_id.hex()[:8], e)
            self._delete_locked(object_id)
            return
        self._spilled[object_id] = entry.size
        self._delete_locked(object_id, notify=False)

    def _spilled_bytes(self) -> int:
        return sum(self._spilled.values())

    def _restore_locked(self, object_id: ObjectID) -> bool:
        """Bring a spilled object back into the store (ref:
        AsyncRestoreSpilledObject, local_object_manager.h:130).  The
        spill record survives a failed restore (e.g. store full of
        pinned entries) so a later access can retry."""
        size = self._spilled.get(object_id)
        if size is None:
            return False
        path = self._spill_path(object_id)
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            self._spilled.pop(object_id, None)
            return False
        try:
            self.create(object_id, payload)
        except ObjectStoreFullError:
            # The arena needs a CONTIGUOUS range: pinned entries can
            # fragment the free space so the alloc fails even though
            # accounting says the payload fits.  A spilled object must
            # not become unreadable while capacity exists — fall back
            # to a file-per-object entry (mmap'd by readers like any
            # file entry; no contiguous requirement).  Only a true
            # accounting shortfall (capacity consumed by pins) keeps
            # the record for a later retry.
            if self._used + size > self._capacity:
                return False           # record kept; retry later
            with open(self.path_of(object_id), "wb") as f:
                f.write(payload)
            self._entries[object_id] = ObjectEntry(
                object_id, size, sealed=True)
            self._used += size
        del self._spilled[object_id]
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        return True

    def _delete_locked(self, object_id: ObjectID,
                       notify: bool = True) -> None:
        entry = self._entries.pop(object_id, None)
        if entry is None:
            return
        if notify and self._on_delete is not None and entry.sealed:
            self._on_delete(object_id)
        if entry.pin_tokens and entry.offset is not None:
            # Live readers hold views into this arena payload (zero-copy
            # gets, in-flight transfer reads).  Tombstone: the entry is
            # gone for lookups (the location record above is retracted)
            # but the range stays allocated until the last unpin —
            # freeing now would let a new put recycle it under a live
            # read-only numpy view (ref: plasma defers deletion of
            # objects with nonzero client map counts).  File-backed
            # entries need no tombstone: POSIX keeps mmaps valid after
            # unlink, and unlinking immediately avoids clobbering the
            # file of a later re-create under the same id.
            self._doomed.append(entry)
            return
        self._free_payload_locked(entry)

    def _free_payload_locked(self, entry: ObjectEntry) -> None:
        self._used -= entry.size
        if entry.offset is not None:
            try:
                self._arena.free(entry.offset)
            except ValueError:
                pass
            return
        try:
            os.unlink(self.path_of(entry.object_id))
        except FileNotFoundError:
            pass

    # ---- read path

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return (object_id in self._entries
                    or object_id in self._spilled)

    def size_of(self, object_id: ObjectID) -> int | None:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry.size if entry else None

    def touch(self, object_id: ObjectID) -> None:
        """LRU bump."""
        with self._lock:
            if object_id in self._entries:
                self._entries.move_to_end(object_id)

    def pin(self, object_id: ObjectID, token) -> None:
        """Pin the current entry for ``object_id`` under a caller-unique
        ``token`` (the daemon's pin-lease token)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                raise ObjectLostError(object_id, "pin on missing object")
            entry.pin_tokens.add(token)

    def unpin(self, object_id: ObjectID, token) -> None:
        """Drop the pin ``token``.  Token-addressed so an unpin after the
        id was deleted and re-created lands on the doomed generation the
        reader actually pinned — never on the new entry."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and token in entry.pin_tokens:
                entry.pin_tokens.discard(token)
                return
            for i, doomed in enumerate(self._doomed):
                if token in doomed.pin_tokens:
                    doomed.pin_tokens.discard(token)
                    if not doomed.pin_tokens:
                        del self._doomed[i]
                        self._free_payload_locked(doomed)
                    return

    def is_doomed(self, object_id: ObjectID) -> bool:
        """True while a deleted-but-still-pinned payload lingers
        (test/introspection hook)."""
        with self._lock:
            return any(d.object_id == object_id for d in self._doomed)

    def delete(self, object_id: ObjectID, notify: bool = True) -> None:
        """notify=False suppresses the on_delete hook — used for GCS-
        driven deletes, where the location record is already gone."""
        with self._lock:
            if self._spilled.pop(object_id, None) is not None:
                try:
                    os.unlink(self._spill_path(object_id))
                except FileNotFoundError:
                    pass
            self._delete_locked(object_id, notify=notify)

    def list_objects(self) -> list[ObjectID]:
        with self._lock:
            return list(self._entries)

    def object_stats(self) -> list[dict]:
        """Per-object residency detail for the memory-attribution join
        (``art memory`` / ``/api/memory``): every resident AND spilled
        object with its size, pin count, and storage tier.  One
        snapshot under the lock — readers get a consistent view."""
        now = time.monotonic()
        with self._lock:
            out = [
                {
                    "object_id": oid.hex(),
                    "size": entry.size,
                    "pins": entry.pin_count,
                    "sealed": entry.sealed,
                    "tier": ("arena" if entry.offset is not None
                             else "file"),
                    "created_age_s": now - entry.created_at,
                }
                for oid, entry in self._entries.items()
            ]
            out.extend(
                {
                    "object_id": oid.hex(),
                    "size": size,
                    "pins": 0,
                    "sealed": True,
                    "tier": "spilled",
                    "created_age_s": None,
                }
                for oid, size in self._spilled.items()
            )
        return out

    def chunk_view_pinned(self, object_id: ObjectID, offset: int,
                          length: int,
                          token) -> memoryview | bytes | None:
        """Serving-side chunk window for the bulk transfer channel:
        arena-backed objects are PINNED under ``token`` and a direct
        arena view is returned — the caller streams it to the socket
        and then calls :meth:`unpin` (the pin keeps the range allocated
        across a concurrent delete via the doomed list, so a mid-send
        eviction can never recycle the bytes under the socket).
        File-backed/spilled objects return a plain read (POSIX keeps
        the bytes stable without a pin).  ``None`` when the object is
        gone."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None and self._restore_locked(object_id):
                entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return None
            self._entries.move_to_end(object_id)
            if entry.offset is not None:
                if offset >= entry.size:
                    return b""
                end = min(offset + length, entry.size)
                entry.pin_tokens.add(token)
                return self._arena.view(entry.offset + offset,
                                        end - offset)
        try:
            with open(self.path_of(object_id), "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            return None

    def read_chunk(self, object_id: ObjectID, offset: int, length: int) -> bytes:
        """Read a chunk for cross-node transfer."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None and self._restore_locked(object_id):
                entry = self._entries.get(object_id)
            if entry is None:
                raise ObjectLostError(object_id, "read on missing object")
            self._entries.move_to_end(object_id)
            if entry.offset is not None:
                end = min(offset + length, entry.size)
                if offset >= entry.size:
                    return b""
                return bytes(self._arena.view(
                    entry.offset + offset, end - offset))
        with open(self.path_of(object_id), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def destroy(self) -> None:
        with self._lock:
            for oid in list(self._entries):
                self._delete_locked(oid)
            if self._arena is not None:
                # Do NOT munmap: in-flight daemon coroutines may still
                # hold raw views into the mapping (native views don't
                # refcount the arena).  Unlink the file and retire the
                # mapping instead — tmpfs space is reclaimed when the
                # last mapping dies at process exit, which is imminent.
                self._retired_arena = self._arena
                self._arena = None
                try:
                    os.unlink(self.arena_path)
                except FileNotFoundError:
                    pass
        try:
            os.rmdir(self._dir)
        except OSError:
            pass


class ObjectStoreFullError(ObjectLostError):
    def __init__(self, message: str):
        Exception.__init__(self, message)


class BufferExistsError(ValueError):
    def __init__(self, object_id: ObjectID, sealed: bool):
        super().__init__(f"buffer for {object_id.hex()[:12]} exists "
                         f"(sealed={sealed})")
        self.object_id = object_id
        self.sealed = sealed


class ArenaClient:
    """Client-side zero-copy windows into node arena files.  One shared
    mapping per arena path; windows are plain memoryview slices, so reads
    and producer writes never copy through an RPC."""

    def __init__(self):
        self._maps: dict[str, memoryview] = {}
        self._lock = make_lock("object_store.mmap_pool")

    def _mapping(self, path: str) -> memoryview:
        with self._lock:
            view = self._maps.get(path)
            if view is None:
                with open(path, "r+b") as f:
                    size = os.fstat(f.fileno()).st_size
                    m = mmap.mmap(f.fileno(), size)
                view = memoryview(m)
                self._maps[path] = view
            return view

    def view(self, path: str, offset: int, size: int) -> memoryview:
        """Window at an *absolute* file offset (the daemon converts from
        payload offsets; clients never know the arena layout)."""
        return self._mapping(path)[offset:offset + size]

    def close(self):
        with self._lock:
            self._maps.clear()


def open_object(path: str) -> memoryview:
    """Client-side zero-copy read: mmap the sealed object file.

    The returned memoryview keeps the mapping alive; deserialized arrays
    referencing it remain valid even if the store evicts (unlinks) the file.
    """
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return memoryview(b"")
        mapping = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        return memoryview(mapping)


def default_store_capacity() -> int:
    """30% of system memory, capped by available tmpfs space."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        total = pages * page_size
    except (ValueError, OSError):  # pragma: no cover
        total = 8 << 30
    cap = int(total * 0.3)
    try:
        stat = os.statvfs("/dev/shm")
        cap = min(cap, int(stat.f_bavail * stat.f_frsize * 0.8))
    except OSError:  # pragma: no cover
        pass
    return max(cap, 64 << 20)
