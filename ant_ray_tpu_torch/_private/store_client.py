"""Pluggable GCS table persistence.

Role of the reference's store clients (ref:
src/ray/gcs/store_client/redis_store_client.h, in_memory_store_client.h):
every GCS table write-throughs to a store client so a restarted head
reloads the cluster instead of electing a leader of nothing.  Redesigned
for this stack: the durable backend is a single sqlite file in the
session dir (no external Redis dependency; WAL mode keeps the write path
on the event loop sub-millisecond), keyed (table, key) → pickled record.
The HA leader selector points standby heads at the same file.
"""

from __future__ import annotations

import logging
import os
import sqlite3


class StoreFenceError(RuntimeError):
    """A remote-store read fence did not drain within its budget: every
    read behind it could be stale.  Raised instead of proceeding — a
    silently-stale read is exactly what follower reads (which build
    read-your-writes on this fence) must not inherit.  The budget is
    the ``store_fence_timeout_s`` config knob."""


class StoreClient:
    """Interface: byte-valued tables keyed by string."""

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def load_table(self, table: str) -> dict[str, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    """Process-local storage — the no-persistence default."""

    def __init__(self):
        self._tables: dict[str, dict[str, bytes]] = {}

    def put(self, table, key, value):
        self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        self._tables.get(table, {}).pop(key, None)

    def load_table(self, table):
        return dict(self._tables.get(table, {}))


class SqliteStoreClient(StoreClient):
    """Durable storage in one sqlite file (WAL journal).

    sqlite connections are not thread-safe by default; the GCS only
    touches the store from its IO loop, but a lock keeps misuse safe.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._lock = make_lock("store_client.sqlite")
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS art_store ("
                "  tbl TEXT NOT NULL, key TEXT NOT NULL, value BLOB,"
                "  PRIMARY KEY (tbl, key))")
            self._conn.commit()

    def put(self, table, key, value):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO art_store (tbl, key, value) "
                "VALUES (?, ?, ?)", (table, key, value))
            self._conn.commit()

    def get(self, table, key):
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM art_store WHERE tbl = ? AND key = ?",
                (table, key)).fetchone()
        return row[0] if row else None

    def delete(self, table, key):
        with self._lock:
            self._conn.execute(
                "DELETE FROM art_store WHERE tbl = ? AND key = ?",
                (table, key))
            self._conn.commit()

    def load_table(self, table):
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM art_store WHERE tbl = ?",
                (table,)).fetchall()
        return {key: value for key, value in rows}

    def close(self):
        with self._lock:
            self._conn.close()


class RemoteStoreClient(StoreClient):
    """Store client over the RPC'd store service (store_server.py) —
    the shared-store HA backend: the head's tables live on another
    machine, so a standby head anywhere can restore them (ref:
    src/ray/gcs/store_client/redis_store_client.h).

    Address form: ``art-store://host:port`` (or bare ``host:port``).
    Calls are synchronous with small retries — table writes are on the
    GCS mutation path, where the reference accepts the same Redis RTT.
    """

    def __init__(self, address: str):
        import asyncio

        from ant_ray_tpu_torch._private.protocol import ClientPool

        self._asyncio = asyncio
        self.address = address.removeprefix("art-store://")
        self._client = ClientPool().get(self.address)
        # Ordered async write-through: GCS table mutations happen ON
        # the io loop, where a blocking round trip would deadlock the
        # loop against itself.  A single drainer task sends the queue
        # in order, retrying each write until it lands — so the store
        # always holds a PREFIX of the mutation history even across
        # store-server blips (the reference's async Redis write-through
        # with callback retries, redis_store_client.h).
        self._writes: asyncio.Queue | None = None
        self._drainer = None
        self._closed = False

    async def _drain_writes(self):
        while True:
            item = await self._writes.get()
            if item is None:
                return
            method, payload = item
            if method == "__fence__":
                # Read barrier: every write enqueued before this fence
                # has landed — release the waiting reader.
                payload.set_result(None)
                continue
            delay = 0.05
            while True:
                try:
                    await self._client.call_async(method, payload,
                                                  timeout=10)
                    break
                except Exception as e:  # noqa: BLE001 — store blip
                    if self._closed:
                        # close() gave up waiting: stop retrying into a
                        # store that will never take this write instead
                        # of spinning (and logging) forever.
                        return
                    logging.getLogger(__name__).warning(
                        "store write %s retrying: %s", method, e)
                    await self._asyncio.sleep(delay)
                    delay = min(delay * 2, 2.0)

    def _submit_write(self, method: str, payload: dict) -> None:
        loop = self._client._io.loop

        def _enqueue():
            if self._writes is None:
                self._writes = self._asyncio.Queue()
                self._drainer = self._asyncio.ensure_future(
                    self._drain_writes())
            self._writes.put_nowait((method, payload))

        loop.call_soon_threadsafe(_enqueue)

    def _read_fence(self, timeout: float | None = None) -> None:
        """Read-your-writes: block until every write this client
        enqueued so far has landed (a fence item through the ordered
        queue).  Without it a get() racing a queued delete/put reads
        the pre-write value.  A fence that does not drain within the
        budget (``store_fence_timeout_s`` by default) raises a typed
        :class:`StoreFenceError` — proceeding would hand the caller
        possibly-stale state with no signal."""
        import concurrent.futures

        from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

        if timeout is None:
            timeout = global_config().store_fence_timeout_s
        fence: concurrent.futures.Future = concurrent.futures.Future()
        loop = self._client._io.loop

        def _enqueue():
            # No queue yet = nothing was ever written; closed = the
            # drainer is gone (close() flushed everything it will).
            # Otherwise the fence must ride the queue even when it
            # looks empty — the drainer pops an item *before* sending
            # it, so emptiness does not mean the last write landed.
            if self._writes is None or self._closed:
                fence.set_result(None)
                return
            self._writes.put_nowait(("__fence__", fence))

        loop.call_soon_threadsafe(_enqueue)
        try:
            fence.result(timeout)
        except concurrent.futures.TimeoutError:
            raise StoreFenceError(
                f"store read fence did not drain within {timeout:.0f}s "
                f"(store {self.address} unreachable or write backlog); "
                "refusing a possibly-stale read") from None

    def put(self, table, key, value):
        self._submit_write("StorePut", {"table": table, "key": key,
                                        "value": value})

    def get(self, table, key):
        self._read_fence()
        return self._client.call("StoreGet",
                                 {"table": table, "key": key}, retries=3)

    def delete(self, table, key):
        self._submit_write("StoreDelete",
                           {"table": table, "key": key})

    def load_table(self, table):
        self._read_fence()
        return self._client.call("StoreLoadTable", {"table": table},
                                 retries=3)

    def close(self):
        """Drain queued writes (bounded) so an orderly head shutdown
        leaves the store holding everything it acknowledged."""
        import concurrent.futures

        loop = self._client._io.loop
        self._closed = True

        async def _flush():
            if self._writes is None:
                return
            self._writes.put_nowait(None)
            await self._drainer
            # Resolve any fence that raced in behind the shutdown
            # sentinel so late readers don't stall out their timeout.
            while not self._writes.empty():
                method, payload = self._writes.get_nowait()
                if method == "__fence__" and not payload.done():
                    payload.set_result(None)

        try:
            self._asyncio.run_coroutine_threadsafe(
                _flush(), loop).result(timeout=5)
        except (concurrent.futures.TimeoutError, Exception):  # noqa: BLE001
            pass


def store_client_for(spec: str | None) -> StoreClient:
    """Resolve a store spec: None -> in-memory, ``art-store://...`` ->
    remote service, anything else -> local sqlite path."""
    if not spec:
        return InMemoryStoreClient()
    if spec.startswith("art-store://"):
        return RemoteStoreClient(spec)
    return SqliteStoreClient(spec)
