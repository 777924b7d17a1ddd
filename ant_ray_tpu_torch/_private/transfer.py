"""Bulk object-transfer data channel.

The control plane (asyncio RPC, protocol.py) is built for many small
messages; pushing multi-MiB transfer chunks through it costs an event
loop wakeup per ~128 KiB of socket buffer on both ends, which caps
node-to-node object bandwidth at a fraction of what the wire (or
loopback) can do.  The reference keeps its object plane on a dedicated
C++ gRPC data path for the same reason (ref: src/ray/object_manager/
object_manager.h — ObjectManager owns its own transfer service,
separate from the raylet's control RPCs).

This module is that data path, redesigned for the plane here:

* **holder side** — ``BulkServer``: one listener thread per node
  daemon; each puller connection gets a handler thread that serves
  ``(object_id, offset, length)`` requests straight from the arena —
  the payload is pinned, then ``sendall``-ed from the arena view, so a
  served chunk never materializes an intermediate ``bytes`` (except
  through the broadcast chunk cache, whose entries are stable copies
  shared across pullers).
* **puller side** — ``pull_chunks``: a blocking-socket worker that
  pipelines up to ``window`` requests ahead on one connection and
  ``recv_into``-s each reply *directly into the arena grant's
  memoryview* — socket → shared memory, no intermediate buffer, no
  event loop on the hot path.  The node daemon runs one worker per
  holder (stripes) via ``run_in_executor``.

Wire format (little protocol, version-fenced by the HELLO byte):

    connect:  client sends  b"ABK1"
    request:  u8 oid_len | oid bytes | u64 offset | u32 length | u8 flags
    reply:    u32 status_or_length | payload
              status 0xFFFFFFFF = object gone (stale holder)

Flags bit 0 marks a striped pull (stats only).
"""

from __future__ import annotations

import itertools
import logging
import socket
import struct
import threading
import time

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.ids import ObjectID

logger = logging.getLogger(__name__)

MAGIC = b"ABK1"
_REQ_HEAD = struct.Struct(">B")            # oid_len
_REQ_BODY = struct.Struct(">QIB")          # offset, length, flags
_REPLY = struct.Struct(">I")               # length | MISS
MISS = 0xFFFFFFFF
FLAG_STRIPE = 1

_bulk_token_counter = itertools.count()


class BulkMiss(RuntimeError):
    """Holder no longer has the object (stale location)."""


def _recv_exactly(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket (raises ConnectionError on EOF)."""
    pos = 0
    n = len(view)
    while pos < n:
        got = sock.recv_into(view[pos:], n - pos)
        if got == 0:
            raise ConnectionResetError("bulk peer closed mid-frame")
        pos += got


class BulkServer:
    """Holder-side bulk chunk server.  ``owner`` is the NodeManager —
    the server shares its object store, chunk cache, transfer counters
    and read log, so RPC-served and bulk-served chunks tally in one
    place."""

    def __init__(self, owner, host: str = "127.0.0.1"):
        self._owner = owner
        self._host = host
        self._sock: socket.socket | None = None
        self._stopping = False
        self.port = 0

    def start(self) -> int:
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="art-bulk-accept").start()
        return self.port

    def stop(self) -> None:
        self._stopping = True
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            sock = self._sock       # stop() nulls the attribute
            if sock is None:
                return
            try:
                conn, _addr = sock.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="art-bulk-serve").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Bound every send/recv: a wedged peer must not hold a
            # served chunk's arena pin (or this thread) forever.
            conn.settimeout(120)
            hello = bytearray(len(MAGIC))
            _recv_exactly(conn, memoryview(hello))
            if bytes(hello) != MAGIC:
                return  # version fence: unknown peer, drop
            while not self._stopping:
                head = bytearray(1)
                _recv_exactly(conn, memoryview(head))
                oid_raw = bytearray(head[0])
                _recv_exactly(conn, memoryview(oid_raw))
                body = bytearray(_REQ_BODY.size)
                _recv_exactly(conn, memoryview(body))
                offset, length, flags = _REQ_BODY.unpack(bytes(body))
                self._serve_chunk(conn, ObjectID(bytes(oid_raw)),
                                  offset, length, flags)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_chunk(self, conn, object_id: ObjectID, offset: int,
                     length: int, flags: int) -> None:
        from ant_ray_tpu_torch._lint.lockcheck import note_blocking  # noqa: PLC0415

        note_blocking("transfer.serve_chunk sendall")
        owner = self._owner
        owner._chunk_read_log.append((object_id.hex(), offset, length))
        delay = global_config().testing_chunk_serve_delay_s
        if delay > 0:
            time.sleep(delay)
        trunc = global_config().testing_chunk_truncate
        if trunc > 0 and length > trunc:
            # Chaos harness: a torn reply — declare and send fewer
            # bytes than the requested chunk.  The puller's length
            # check fails the pump, exercising stripe failover.
            view = owner.store.chunk_view_pinned(
                object_id, offset, trunc,
                token := ("bulk", next(_bulk_token_counter)))
            if view is None:
                conn.sendall(_REPLY.pack(MISS))
                return
            try:
                conn.sendall(_REPLY.pack(trunc))
                conn.sendall(view)
            finally:
                owner.store.unpin(object_id, token)
            return
        key = (object_id, offset, length)
        cached = owner.cache_get_chunk(key)
        if cached is not None:
            owner._bump_stats(chunk_cache_hits=1,
                              **({"stripe_cache_hits": 1}
                                 if flags & FLAG_STRIPE else {}))
            conn.sendall(_REPLY.pack(len(cached)))
            conn.sendall(cached)
            return
        token = ("bulk", next(_bulk_token_counter))
        view = owner.store.chunk_view_pinned(object_id, offset, length,
                                             token)
        if view is None:
            conn.sendall(_REPLY.pack(MISS))
            return
        try:
            owner._bump_stats(chunk_reads=1)
            owner.cache_put_chunk(key, view)
            # Zero-copy serve: arena → kernel.  The pin keeps the range
            # allocated even if the object is deleted mid-send (doomed
            # entries release on unpin).
            conn.sendall(_REPLY.pack(len(view)))
            conn.sendall(view)
        finally:
            owner.store.unpin(object_id, token)


def pull_chunks(address: tuple, object_id: ObjectID, size: int,
                chunk: int, window: int, take, requeue, write,
                striped: bool, progress: list | None = None,
                timeout_s: float = 60.0) -> int:
    """Blocking bulk-pull worker: drain chunk offsets from ``take()``
    over one pipelined connection, ``recv_into`` each straight into the
    grant via ``write(offset, length) -> memoryview``.  Returns the
    payload bytes successfully written; ``progress`` (a one-slot list
    written only by this worker) carries the same tally across the
    exception path, so bytes a dying holder already delivered still
    count (they are deliberately never re-pulled).

    Runs in an executor thread (never on the io loop).  On any failure
    every taken-but-incomplete offset is handed to ``requeue`` so a
    surviving holder can finish the stripe without re-pulling a byte —
    a taken offset is registered in ``inflight`` BEFORE its request is
    sent, so a failing send can never strand a chunk.
    """
    inflight: list[tuple[int, int]] = []   # (offset, length) issued
    pulled = 0
    from ant_ray_tpu_torch._lint.lockcheck import note_blocking  # noqa: PLC0415

    note_blocking("transfer.pull_chunks socket I/O")
    sock = socket.create_connection(address, timeout=timeout_s)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout_s)
        sock.sendall(MAGIC)
        flags = FLAG_STRIPE if striped else 0
        oid_raw = object_id.binary()
        req_tail = bytearray(_REQ_BODY.size)
        reply_head = bytearray(_REPLY.size)
        while True:
            while len(inflight) < max(1, window):
                off = take()
                if off is None:
                    break
                n = min(chunk, size - off)
                inflight.append((off, n))
                _REQ_BODY.pack_into(req_tail, 0, off, n, flags)
                sock.sendall(_REQ_HEAD.pack(len(oid_raw)) + oid_raw
                             + req_tail)
            if not inflight:
                return pulled
            off, n = inflight[0]
            _recv_exactly(sock, memoryview(reply_head))
            (got,) = _REPLY.unpack(bytes(reply_head))
            if got == MISS:
                raise BulkMiss(object_id.hex()[:12])
            if got != n:
                raise ConnectionResetError(
                    f"bulk holder replied {got} bytes for a {n}-byte "
                    f"chunk at {off}")
            _recv_exactly(sock, write(off, n))
            inflight.pop(0)
            pulled += n
            if progress is not None:
                progress[0] = pulled
    except BaseException:
        for off, _n in inflight:
            requeue(off)
        raise
    finally:
        try:
            sock.close()
        except OSError:
            pass
