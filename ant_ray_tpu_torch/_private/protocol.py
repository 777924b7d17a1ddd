"""Asyncio RPC substrate for the control plane.

Role-equivalent to the reference's gRPC wrappers
(ref: src/ray/rpc/grpc_server.h, retryable_grpc_client.h, rpc_chaos.h) with a
lighter transport: length-prefixed pickle frames over TCP, one shared
background IO thread per process (the analogue of the instrumented asio
io_context, ref: src/ray/common/asio/).  The public surface — ``RpcServer``
with async method handlers, ``RpcClient.call`` with retries and deadline, and
deterministic chaos fault injection — is transport-agnostic so it can be
re-hosted on gRPC without touching callers.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import random
import socket
import threading
import time
from typing import Any, Awaitable, Callable

from ant_ray_tpu_torch._private import hotframe
from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.specs import TaskSpec

logger = logging.getLogger(__name__)


def _trace_current():
    """Sampled trace context active in this task, or None.  Lazy-bound:
    the tracing plane imports config (not protocol), so binding at
    first use avoids ordering surprises during package init."""
    global _trace_current
    from ant_ray_tpu_torch.observability.tracing_plane import (  # noqa: PLC0415
        current_sampled,
    )

    _trace_current = current_sampled
    return current_sampled()

_REQ, _REP, _ERR, _ONEWAY, _HELLO, _GOODBYE = 0, 1, 2, 3, 4, 5
# Pseudo-kind yielded by _read_frame for hot-flagged frames: the body
# is handed to the hot-frame codec undecoded (the per-connection
# template table lives with the caller, not the reader).
_HOT = 6

# Wire protocol version (ref: protobuf schema versioning — the pickled
# tuple frames are a fixed contract per version; mixed-version nodes
# fail fast at connect with a clear error instead of corrupting state
# mid-RPC).  Bump on any change to frame shapes or payload contracts;
# see wire_schema.py for the per-method payload registry.
PROTOCOL_VERSION = 1

_HEADER = 8  # u64 big-endian frame length

# Top header bit marks a RAW frame: the body is
# ``u32 meta_len | pickle((kind, msg_id, method, None)) | payload bytes``
# and the payload is handed to the caller as a memoryview over the read
# buffer instead of travelling through pickle.  Raw frames are only ever
# sent in REPLY to a method that opts in (ReadChunkRaw), so the change
# is additive within PROTOCOL_VERSION — peers that never ask never see
# one.
_RAW_FLAG = 1 << 63

# Second header bit marks a HOT frame (hotframe.py): the body is a
# compact struct-packed PushTask call / template / batched-ack record
# set that never round-trips through pickle.  Hot frames are only ever
# sent to peers that advertised ``hot`` in the HELLO handshake (and
# were acked), so the change is additive within PROTOCOL_VERSION —
# peers that never negotiated never see one.
_HOT_FLAG = 1 << 62
_LEN_MASK = _HOT_FLAG - 1


class RawReply:
    """Handler-return wrapper: reply with ``data`` as a raw out-of-band
    frame (no pickle copy of the payload).  ``data`` may be bytes or a
    memoryview; it is consumed synchronously by the transport write, so
    views into shared memory are safe as long as the handler returns on
    the io loop without an intervening await (fast routes).

    ``release`` (optional) is invoked exactly once after the transport
    consumed the payload (or the reply was dropped) — handlers use it
    to unpin shared-memory windows they served from."""

    __slots__ = ("data", "release")

    def __init__(self, data, release=None):
        self.data = data
        self.release = release

    def done(self) -> None:
        release, self.release = self.release, None
        if release is not None:
            try:
                release()
            except Exception:  # noqa: BLE001 — reply path must not die
                logger.exception("RawReply release hook failed")

# Transport write-buffer level above which senders await drain (flow
# control); below it, frames are written inline with no await.  Shared by
# client sends and server replies.
_DRAIN_THRESHOLD = 1 << 20


class RpcError(Exception):
    pass


class RpcConnectionError(RpcError):
    pass


class RpcTimeoutError(RpcError):
    pass


class NotLeaderError(RpcError):
    """A GCS mutation reached a replica that is not (or no longer) the
    leader.  Carries the leader's address when the replica knows it, so
    the client-side router (gcs_client.GcsRouter) can redirect instead
    of surfacing "no route".  Raised server-side by the HA mutation
    guard; travels the wire pickled like any handler exception."""

    def __init__(self, leader_addr: str = ""):
        super().__init__(
            "not the GCS leader"
            + (f" (leader at {leader_addr})" if leader_addr
               else " (no leader elected yet)"))
        self.leader_addr = leader_addr

    def __reduce__(self):
        # Default exception pickling replays ``args`` (the formatted
        # message) into __init__, which would masquerade as an address.
        return (NotLeaderError, (self.leader_addr,))


class _ChaosInjector:
    """Deterministic RPC fault injection (ref: src/ray/rpc/rpc_chaos.h:24).

    Config string: ``"method:prob,method2:prob"``; seeded RNG so failures are
    reproducible across runs with the same seed.  A ``seed:<n>`` entry in the
    spec overrides the ``seed`` argument — the channel the chaos harness
    (util/chaos.py) uses to carry its schedule seed through ``_system_config``
    into every daemon's injector.
    """

    def __init__(self, spec: str, seed: int = 0, latency_spec: str = ""):
        self._probs: dict[str, float] = {}
        for part in filter(None, (spec or "").split(",")):
            method, prob = part.split(":")
            if method == "seed":
                seed = int(float(prob))
                continue
            self._probs[method] = float(prob)
        self._rng = random.Random(seed)
        # Per-method injected latency (testing_rpc_latency_s): applied
        # client-side before the request frame is written — the
        # deterministic stand-in for a slow replica / congested link.
        self._delays: dict[str, float] = {}
        for part in filter(None, (latency_spec or "").split(",")):
            method, secs = part.split(":")
            if method == "seed":
                continue
            self._delays[method] = float(secs)

    def should_fail(self, method: str) -> bool:
        prob = self._probs.get(method, 0.0)
        return prob > 0 and self._rng.random() < prob

    def delay_for(self, method: str) -> float:
        return self._delays.get(method, 0.0) if self._delays else 0.0


# ------------------------------------------------------------------- io loop

class IoThread:
    """One background asyncio loop per process; all servers/clients share it."""

    _instance: "IoThread | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name="art-io", daemon=True
        )
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    @classmethod
    def get(cls) -> "IoThread":
        with cls._lock:
            if cls._instance is None or not cls._instance._thread.is_alive():
                cls._instance = cls()
            return cls._instance

    def run_coro(self, coro: Awaitable, timeout: float | None = None) -> Any:
        """Run a coroutine on the io loop from a foreign thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def call_soon(self, fn: Callable, *args) -> None:
        self.loop.call_soon_threadsafe(fn, *args)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.loop.call_soon_threadsafe(inst.loop.stop)


def _release_raw_result(fut: "asyncio.Future") -> None:
    try:
        result = fut.result()
    except Exception:  # noqa: BLE001 — handler error, nothing to free
        return
    if isinstance(result, RawReply):
        result.done()


# asyncio's loop keeps only weak refs to tasks; hold strong refs here so
# fire-and-forget dispatch/read-loop tasks are never GC'd mid-flight.
_background_tasks: set = set()


def _spawn(coro) -> None:
    task = asyncio.ensure_future(coro)
    _background_tasks.add(task)
    task.add_done_callback(_background_tasks.discard)


# ------------------------------------------------- wire cost accounting
#
# (method, direction) -> [frames, bytes, encode_ns]: this process's
# cumulative control-plane wire cost, per wire_schema method.  The
# hotframe.counters idiom — a module dict mutated without a lock; each
# list-slot += is a handful of GIL-serialized bytecodes, and a lost
# increment under a rare interleave is acceptable for accounting that
# exists to rank methods by cost.  The profiler's publish tick rolls the
# deltas up into art_rpc_bytes_total / art_rpc_frames_total through
# MetricRecord (see observability/cpu_profiler.py), so per-node
# control-plane cost is a scrapeable series.

wire_counters: dict = {}
_wire_published: dict = {}


def _wire_account(method: str, direction: str, nbytes: int,
                  encode_ns: int = 0, conn_stats: dict | None = None):
    key = (method, direction)
    entry = wire_counters.get(key)
    if entry is None:
        entry = wire_counters.setdefault(key, [0, 0, 0])
    entry[0] += 1
    entry[1] += nbytes
    entry[2] += encode_ns
    if conn_stats is not None:
        conn_entry = conn_stats.get(key)
        if conn_entry is None:
            conn_entry = conn_stats.setdefault(key, [0, 0, 0])
        conn_entry[0] += 1
        conn_entry[1] += nbytes
        conn_entry[2] += encode_ns


def wire_deltas() -> dict:
    """(method, direction) -> (frames, bytes, encode_ns) accumulated
    since the previous call.  Single-consumer by design: the process's
    profiler publish tick owns the delta cursor; tests and debuggers
    read ``wire_counters`` directly."""
    out = {}
    for key, entry in list(wire_counters.items()):
        totals = (entry[0], entry[1], entry[2])
        last = _wire_published.get(key, (0, 0, 0))
        delta = (totals[0] - last[0], totals[1] - last[1],
                 totals[2] - last[2])
        if any(delta):
            out[key] = delta
            _wire_published[key] = totals
    return out


# Server-side handle time, the other half of the cost picture: wire
# accounting says what a method moves, handle accounting says what it
# COSTS the serving loop — dispatch→reply-encoded ns per method (async
# routes) or the sync handler call itself (fast routes, where chasing
# Future completion would tax the PushTask hot path with a callback).
# Same lock-free module-global idiom as wire_counters above.

handle_counters: dict = {}
_handle_published: dict = {}


def _handle_account(method: str, handle_ns: int) -> None:
    entry = handle_counters.get(method)
    if entry is None:
        entry = handle_counters.setdefault(method, [0, 0])
    entry[0] += 1
    entry[1] += handle_ns


def handle_deltas() -> dict:
    """method -> (calls, handle_ns) accumulated since the previous
    call.  Single-consumer cursor, like :func:`wire_deltas`."""
    out = {}
    for method, entry in list(handle_counters.items()):
        totals = (entry[0], entry[1])
        last = _handle_published.get(method, (0, 0))
        delta = (totals[0] - last[0], totals[1] - last[1])
        if any(delta):
            out[method] = delta
            _handle_published[method] = totals
    return out


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    """One frame off the wire: ``(kind, msg_id, method, payload,
    nbytes)`` — nbytes is the full on-wire size (header included), the
    recv side of wire accounting."""
    header = await reader.readexactly(_HEADER)
    length = int.from_bytes(header, "big")
    if length & _HOT_FLAG:
        # Hand the body over undecoded: hot-frame decode needs the
        # per-connection template table, which the caller owns.
        body_len = length & _LEN_MASK
        data = await reader.readexactly(body_len)
        return _HOT, -1, "", data, _HEADER + body_len
    if length & _RAW_FLAG:
        body_len = length & ~_RAW_FLAG
        data = await reader.readexactly(body_len)
        meta_len = int.from_bytes(data[:4], "big")
        kind, msg_id, method, _ = pickle.loads(data[4:4 + meta_len])
        # Zero-copy hand-off: a view over the (immutable) read buffer.
        return (kind, msg_id, method, memoryview(data)[4 + meta_len:],
                _HEADER + body_len)
    data = await reader.readexactly(length)
    kind, msg_id, method, payload = pickle.loads(data)
    return kind, msg_id, method, payload, _HEADER + length


def _encode_frame(msg: Any) -> bytes:
    data = pickle.dumps(msg, protocol=5)
    return len(data).to_bytes(_HEADER, "big") + data


def _encode_hot_frame(body: bytes) -> bytes:
    """Frame one hot-codec body (hotframe.py encodes bodies only; the
    transport header lives here with its sibling flags)."""
    return (len(body) | _HOT_FLAG).to_bytes(_HEADER, "big") + body


class _HotSendState:
    """Per-connection hot-wire send state: established when the peer's
    HELLO-ack lands, discarded with the connection (``writer`` is the
    generation tag — a reconnect invalidates templates the new peer
    never saw, so stale state must never outlive its socket)."""

    __slots__ = ("writer", "version", "templates")

    def __init__(self, writer, version: int):
        self.writer = writer
        self.version = version
        self.templates = hotframe.TemplateCache()


class _ServerConn:
    """Per-connection server state: the receiver half of the template
    cache plus the coalesced-ack buffer (one flush = one frame carrying
    every reply that completed in the same io-loop tick)."""

    __slots__ = ("writer", "write_lock", "templates", "acks",
                 "flush_scheduled", "wire_stats")

    def __init__(self, writer, write_lock):
        self.writer = writer
        self.write_lock = write_lock
        self.templates: dict[int, tuple] = {}
        self.acks: list[bytes] = []
        self.flush_scheduled = False
        # Per-connection (method, direction) -> [frames, bytes,
        # encode_ns], mirrored into the module-level rollup.
        self.wire_stats: dict = {}


def _encode_raw_head(kind: int, msg_id: int, method: str,
                     payload_len: int) -> bytes:
    """Header + meta for a raw frame; the payload bytes are written
    separately by the caller (so an arena view never round-trips
    through pickle)."""
    meta = pickle.dumps((kind, msg_id, method, None), protocol=5)
    total = 4 + len(meta) + payload_len
    return ((total | _RAW_FLAG).to_bytes(_HEADER, "big")
            + len(meta).to_bytes(4, "big") + meta)


# -------------------------------------------------------------------- server

class RpcServer:
    """Async RPC server. Handlers: ``async def h(payload) -> reply``.

    Register with :meth:`route`; a handler raising propagates the exception to
    the caller (pickled, re-raised client-side as its original type).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._routes: dict[str, Callable[[Any], Awaitable[Any]]] = {}
        # Sync handlers returning a value or a Future: dispatched without
        # creating a coroutine/Task per request — the hot-path shape for
        # task execution (handler enqueues to an executor and returns its
        # reply future).
        self._fast_routes: dict[str, Callable[[Any], Any]] = {}
        self._server: asyncio.AbstractServer | None = None
        self._io = IoThread.get()
        self.address: str = ""
        # Per-instance hot-wire gate (seeded from config): never ack a
        # client's hot advertisement when off — the seam mixed-version
        # interop tests flip to stand in for a pre-hot-wire server.
        self._hot_enabled = global_config().hot_wire_enabled

    def route(self, method: str, handler: Callable[[Any], Awaitable[Any]]):
        self._routes[method] = handler

    def routes(self, handlers: dict[str, Callable]):
        self._routes.update(handlers)

    def fast_route(self, method: str, handler: Callable[[Any], Any]):
        """Register a SYNC handler (may return an asyncio.Future)."""
        self._fast_routes[method] = handler

    def start(self) -> str:
        self._io.run_coro(self._start())
        return self.address

    async def _start(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port
        )
        port = self._server.sockets[0].getsockname()[1]
        self.address = f"{self._host}:{port}"

    async def _handle_conn(self, reader, writer):
        # One write lock per connection: replies are written by concurrently
        # dispatched handler tasks, and StreamWriter.drain() is not safe to
        # call from two coroutines at once when flow control pauses the
        # transport (FlowControlMixin._drain_helper asserts).
        write_lock = asyncio.Lock()
        conn = _ServerConn(writer, write_lock)
        try:
            while True:
                try:
                    kind, msg_id, method, payload, nbytes = \
                        await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                # Hot frames carry no method name on the wire — that is
                # the point of the template cache — but every hot call
                # is a PushTask by contract, so the accounting stays
                # per-method.
                _wire_account("PushTask" if kind == _HOT else method,
                              "recv", nbytes, conn_stats=conn.wire_stats)
                if kind == _HELLO:
                    peer = (payload or {}).get("proto")
                    if peer != PROTOCOL_VERSION:
                        # Version fence: reply GOODBYE (so the client
                        # fails every call with a clear upgrade message)
                        # and drop the connection.
                        self._write_reply(
                            writer, write_lock,
                            (_GOODBYE, msg_id, method,
                             {"proto": PROTOCOL_VERSION,
                              "reason": f"peer wire protocol v{peer} is "
                                        f"not v{PROTOCOL_VERSION}"}))
                        return
                    # Hot-wire negotiation (additive within the
                    # version): a peer advertising ``hot`` gets an ack
                    # and MAY then send hot frames; a peer that never
                    # advertises (older build, or hot_wire_enabled
                    # off) never hears back and stays fully pickled.
                    if (payload or {}).get("hot") and self._hot_enabled:
                        self._write_reply(
                            writer, write_lock,
                            (_HELLO, -1, "__hello__",
                             {"proto": PROTOCOL_VERSION,
                              "hot": hotframe.HOT_WIRE_VERSION}))
                    continue
                if kind == _HOT:
                    self._dispatch_hot(conn, payload)
                    continue
                fast = self._fast_routes.get(method)
                if fast is not None:
                    self._dispatch_fast(writer, write_lock, kind, msg_id,
                                        method, payload, fast)
                    continue
                _spawn(
                    self._dispatch(
                        writer, write_lock, kind, msg_id, method, payload)
                )
        finally:
            writer.close()

    def _dispatch_fast(self, writer, write_lock, kind, msg_id, method,
                       payload, handler):
        """Task-free dispatch for sync handlers: the reply is written by
        a future callback (or inline for immediate values).  Handle
        accounting times only the sync handler call — for a handler
        that returns a Future the queue/execute tail is the worker's
        cost, not this io loop's, and chasing completion would add a
        callback to the hottest path on the wire."""
        h0 = time.perf_counter_ns()
        try:
            result = handler(payload)
            _handle_account(method, time.perf_counter_ns() - h0)
        except Exception as e:  # noqa: BLE001 — forwarded to caller
            if kind != _ONEWAY:
                self._write_reply(writer, write_lock,
                                  (_ERR, msg_id, method, e))
            else:
                logger.exception("oneway fast handler %s failed", method)
            return
        if isinstance(result, asyncio.Future):
            if kind == _ONEWAY:
                # Nobody consumes the reply: still release any raw
                # payload's resources (e.g. a served chunk's pin).
                result.add_done_callback(_release_raw_result)
                return
            result.add_done_callback(
                lambda f: self._write_reply_of(writer, write_lock,
                                               msg_id, method, f))
            return
        if kind != _ONEWAY:
            self._write_reply(writer, write_lock,
                              (_REP, msg_id, method, result))
        elif isinstance(result, RawReply):
            result.done()

    # ------------------------------------------------------ hot dispatch

    def _dispatch_hot(self, conn: _ServerConn, body) -> None:
        """Task-free dispatch of one hot frame (io loop).  A HOT_CALL
        maps to the PushTask fast route by contract; its reply is
        queued into the connection's coalesced-ack batch instead of
        going out as its own frame."""
        hkind = body[0] if body else -1
        if hkind == hotframe.HOT_TEMPLATE:
            try:
                tid, fields = hotframe.decode_template(body)
            except hotframe.HotFrameError as e:
                logger.warning("dropped undecodable hot template: %s", e)
                return
            conn.templates[tid] = fields
            return
        if hkind != hotframe.HOT_CALL:
            logger.warning("dropped hot frame of unknown kind %r", hkind)
            return
        try:
            msg_id, spec = hotframe.decode_call(body, conn.templates)
        except hotframe.HotFrameError as e:
            if e.msg_id is not None:
                # The head parsed: fail THAT call instead of leaving
                # its future to hang client-side.
                self._queue_hot_ack(conn, hotframe.encode_ack_exc(
                    e.msg_id, RpcError(str(e))))
            else:
                logger.warning("dropped undecodable hot call: %s", e)
            return
        handler = self._fast_routes.get("PushTask")
        if handler is None:
            self._queue_hot_ack(conn, hotframe.encode_ack_exc(
                msg_id, RpcError("no route for method 'PushTask'")))
            return
        try:
            result = handler(spec)
        except Exception as e:  # noqa: BLE001 — forwarded to caller
            self._queue_hot_ack(conn, hotframe.encode_ack_exc(msg_id, e))
            return
        if isinstance(result, asyncio.Future):
            # Context rides ON the future (preallocated tuple + one
            # shared bound method) — no closure per call.
            result._art_hot_ctx = (conn, msg_id)
            result.add_done_callback(self._hot_ack_cb)
        else:
            self._queue_hot_reply(conn, msg_id, result)

    def _hot_ack_cb(self, fut: asyncio.Future) -> None:
        conn, msg_id = fut._art_hot_ctx
        try:
            reply = fut.result()
        except Exception as e:  # noqa: BLE001 — forwarded to caller
            self._queue_hot_ack(conn, hotframe.encode_ack_exc(msg_id, e))
            return
        self._queue_hot_reply(conn, msg_id, reply)

    def _queue_hot_reply(self, conn: _ServerConn, msg_id: int, reply):
        rec = hotframe.encode_ack(msg_id, reply)
        if rec is None:
            # Unknown reply shape: fall back to a pickled reply frame
            # for just this call — the client resolves futures by
            # msg_id on either path, so mixing is safe.
            self._write_reply(conn.writer, conn.write_lock,
                              (_REP, msg_id, "PushTask", reply))
            return
        self._queue_hot_ack(conn, rec)

    def _queue_hot_ack(self, conn: _ServerConn, rec: bytes) -> None:
        conn.acks.append(rec)
        if not conn.flush_scheduled:
            conn.flush_scheduled = True
            self._io.loop.call_soon(self._flush_hot_acks, conn)

    def _flush_hot_acks(self, conn: _ServerConn) -> None:
        """One frame, N acks: every reply completed since the last tick
        ships in a single transport write."""
        conn.flush_scheduled = False
        if not conn.acks:
            return
        records, conn.acks = conn.acks, []
        t0 = time.perf_counter_ns()
        frame = _encode_hot_frame(hotframe.frame_acks(records))
        _wire_account("PushTask", "send", len(frame),
                      time.perf_counter_ns() - t0, conn.wire_stats)
        try:
            conn.writer.write(frame)
            if conn.writer.transport.get_write_buffer_size() > \
                    _DRAIN_THRESHOLD:
                _spawn(self._drain_locked(conn.writer, conn.write_lock))
        except (ConnectionResetError, BrokenPipeError):
            pass

    def _write_reply_of(self, writer, write_lock, msg_id, method,
                        fut: asyncio.Future):
        try:
            msg = (_REP, msg_id, method, fut.result())
        except Exception as e:  # noqa: BLE001 — forwarded to caller
            msg = (_ERR, msg_id, method, e)
        self._write_reply(writer, write_lock, msg)

    def _write_reply(self, writer, write_lock, msg):
        if isinstance(msg[3], RawReply):
            data = msg[3].data
            try:
                # Two writes, both synchronous: the transport consumes
                # the payload view before returning, so a shared-memory
                # window is safe to hand over without copying.
                head = _encode_raw_head(msg[0], msg[1], msg[2],
                                        len(data))
                _wire_account(msg[2], "send", len(head) + len(data))
                writer.write(head)
                writer.write(data)
                if writer.transport.get_write_buffer_size() > \
                        _DRAIN_THRESHOLD:
                    _spawn(self._drain_locked(writer, write_lock))
            except (ConnectionResetError, BrokenPipeError):
                pass
            finally:
                msg[3].done()
            return
        t0 = time.perf_counter_ns()
        try:
            frame = _encode_frame(msg)
        except Exception:  # noqa: BLE001 — unpicklable error payload
            frame = _encode_frame((_ERR, msg[1], msg[2],
                                   RpcError(repr(msg[3]))))
        _wire_account(msg[2], "send", len(frame),
                      time.perf_counter_ns() - t0)
        try:
            writer.write(frame)
            if writer.transport.get_write_buffer_size() > _DRAIN_THRESHOLD:
                _spawn(self._drain_locked(writer, write_lock))
        except (ConnectionResetError, BrokenPipeError):
            pass

    @staticmethod
    async def _drain_locked(writer, write_lock):
        try:
            async with write_lock:
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    async def _dispatch(self, writer, write_lock, kind, msg_id, method,
                        payload):
        handler = self._routes.get(method)
        h0 = time.perf_counter_ns()
        try:
            if handler is None:
                raise RpcError(f"no route for method {method!r}")
            result = await handler(payload)
            if kind == _ONEWAY:
                _handle_account(method, time.perf_counter_ns() - h0)
                if isinstance(result, RawReply):
                    result.done()
                return
            if isinstance(result, RawReply):
                # NOTE: an await boundary separates the handler from
                # this write, so async raw replies must carry bytes
                # (not live arena views — those are fast-route only).
                _handle_account(method, time.perf_counter_ns() - h0)
                self._write_reply(writer, write_lock,
                                  (_REP, msg_id, method, result))
                return
            t0 = time.perf_counter_ns()
            frame = _encode_frame((_REP, msg_id, method, result))
            t1 = time.perf_counter_ns()
            _wire_account(method, "send", len(frame), t1 - t0)
            _handle_account(method, t1 - h0)
        except Exception as e:  # noqa: BLE001 — forwarded to caller
            if kind == _ONEWAY:
                logger.exception("oneway handler %s failed", method)
                return
            try:
                frame = _encode_frame((_ERR, msg_id, method, e))
            except Exception:
                frame = _encode_frame((_ERR, msg_id, method, RpcError(repr(e))))
            _wire_account(method, "send", len(frame))
            _handle_account(method, time.perf_counter_ns() - h0)
        try:
            # Fast path mirrors RpcClient._write_frame: plain write when
            # the transport buffer is shallow, locked drain only under
            # back-pressure (concurrent drains are unsafe when paused).
            writer.write(frame)
            if writer.transport.get_write_buffer_size() > _DRAIN_THRESHOLD:
                async with write_lock:
                    await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass

    def stop(self):
        if self._server is not None:
            async def _close(server):
                server.close()
                # 3.12 wait_closed() waits for every open CONNECTION,
                # not just the listening socket — peers keep theirs open
                # (pooled clients), so an unbounded wait stalls every
                # shutdown for the full run_coro timeout.  Closing the
                # listener is what matters; give stragglers a beat.
                try:
                    await asyncio.wait_for(server.wait_closed(), 0.2)
                except asyncio.TimeoutError:
                    pass

            try:
                self._io.run_coro(_close(self._server), timeout=2)
            except Exception:
                pass
            self._server = None


# -------------------------------------------------------------------- client

class RpcClient:
    """Connection to one RpcServer; safe to call from any thread."""

    _counter = itertools.count()

    def __init__(self, address: str):
        self.address = address
        self._io = IoThread.get()
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._conn_lock: asyncio.Lock | None = None
        # Serializes write+drain: concurrent drains on one StreamWriter are
        # unsafe once the transport pauses (see server-side note).  Lock
        # acquisition is FIFO, so sequential senders keep their send order.
        self._write_lock: asyncio.Lock | None = None
        # (frame, reply-future, writer-tag) triples deferred by
        # send_request(defer=True), written in one syscall by
        # flush_deferred() (pipelined task pushes); discard_deferred()
        # fails the futures of frames that were never shipped so
        # callers can retry instead of hanging.  The writer tag is None
        # for connection-agnostic pickled frames; hot frames carry the
        # writer they were encoded for (their template ids mean nothing
        # to any other connection) and are failed instead of shipped if
        # the connection turned over before the flush.
        self._outbox: list[tuple[bytes, asyncio.Future, Any]] = []
        # Hot-wire send state, established by the server's HELLO-ack
        # and keyed to the connection it arrived on (see _HotSendState).
        self._hot: _HotSendState | None = None
        self._chaos = _ChaosInjector(
            global_config().testing_rpc_failure,
            latency_spec=global_config().testing_rpc_latency_s)
        # Chaos-free is the production shape: precomputed so the sync
        # send fast path can skip the injector entirely.
        self._chaos_active = bool(self._chaos._probs
                                  or self._chaos._delays)
        self._closed = False
        # Per-client (method, direction) -> [frames, bytes, encode_ns]
        # wire cost, mirrored into the module-level rollup (survives
        # reconnects: the unit of attribution is the peer, not the
        # socket generation).
        self.wire_stats: dict = {}
        # Shared done-callback for pending-entry cleanup (a per-call
        # lambda with a default-arg cell allocates a closure each).
        self._pop_pending_cb = self._pop_pending

    async def _ensure_connected(self):
        # Lock-free fast path: on an established connection this runs on
        # every request, and even an uncontended Lock acquire is
        # measurable at 10k calls/s.
        writer = self._writer
        if writer is not None and not writer.is_closing():
            return
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        if self._write_lock is None:
            self._write_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            host, port = self.address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)),
                    global_config().rpc_connect_timeout_s,
                )
            except (OSError, asyncio.TimeoutError) as e:
                raise RpcConnectionError(
                    f"cannot connect to {self.address}: {e}"
                ) from e
            self._writer = writer
            # Version handshake: first frame on every connection (ref:
            # schema versioning — mixed-version peers fail fast with an
            # actionable error, not a pickle explosion mid-call).
            # Sentinel id -1: a pre-handshake server would dispatch
            # "__hello__" as a normal request and reply an error frame —
            # which must not collide with a real pending msg_id (the
            # shared counter starts at 0).
            hello = {"proto": PROTOCOL_VERSION}
            if global_config().hot_wire_enabled:
                # Advertise the hot wire; frames stay pickled until
                # (unless) the server's HELLO-ack lands.
                hello["hot"] = hotframe.HOT_WIRE_VERSION
            hello_frame = _encode_frame((_HELLO, -1, "__hello__", hello))
            _wire_account("__hello__", "send", len(hello_frame),
                          conn_stats=self.wire_stats)
            writer.write(hello_frame)
            _spawn(self._read_loop(reader, writer))

    async def _read_loop(self, reader, writer):
        version_err = None
        try:
            while True:
                kind, msg_id, _method, payload, nbytes = \
                    await _read_frame(reader)
                # Reply frames carry their method; coalesced hot-ack
                # frames are all PushTask replies by contract.
                _wire_account("PushTask" if kind == _HOT else _method,
                              "recv", nbytes, conn_stats=self.wire_stats)
                if kind == _GOODBYE:
                    version_err = RpcError(
                        f"{self.address} rejected this process: "
                        f"{(payload or {}).get('reason', 'version fence')}"
                        " — upgrade the older side")
                    return
                if kind == _HELLO:
                    # HELLO-ack: the peer speaks the hot wire.  Fresh
                    # template cache, keyed to THIS connection.
                    peer = (payload or {}).get("hot", 0)
                    if peer:
                        self._hot = _HotSendState(
                            writer,
                            min(peer, hotframe.HOT_WIRE_VERSION))
                    continue
                if kind == _HOT:
                    try:
                        self._on_hot_acks(payload)
                    except hotframe.HotFrameError as e:
                        # decode_acks' contract: an undecodable ack
                        # frame is a DEAD connection, not a skippable
                        # record — later record boundaries are unknown,
                        # so every reply batched behind the corruption
                        # would leave its caller hanging forever.  Kill
                        # the socket; the teardown below fails this
                        # connection's pending futures for retry.
                        version_err = RpcError(
                            f"undecodable hot ack frame from "
                            f"{self.address}: {e}")
                        writer.close()
                        return
                    continue
                fut = self._pending.get(msg_id)
                if fut is None or fut.done():
                    continue
                if kind == _ERR:
                    fut.set_exception(
                        payload if isinstance(payload, BaseException)
                        else RpcError(str(payload))
                    )
                else:
                    fut.set_result(payload)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            # Guarded teardown: a stale loop racing a completed
            # reconnect must not clobber the NEW connection's writer,
            # its negotiated hot state, OR its in-flight calls — every
            # step below is scoped to THIS loop's connection.
            if self._writer is writer:
                self._writer = None
            hot = self._hot
            if hot is not None and hot.writer is writer:
                self._hot = None
            # Deferred frames must not survive into a reconnected writer
            # (replaying a stale PushTask double-executes the task).
            self.discard_deferred(writer=writer)
            err = version_err or RpcConnectionError(
                f"connection to {self.address} lost")
            for msg_id, fut in list(self._pending.items()):
                if fut._art_writer is not writer:
                    continue
                self._pending.pop(msg_id, None)
                if not fut.done():
                    fut.set_exception(err)

    def _on_hot_acks(self, body) -> None:
        """Resolve every future whose reply rode the coalesced ack
        frame (one frame, N acks).  Raises :class:`HotFrameError` on an
        undecodable frame — the read loop treats that as fatal to the
        connection (the batched replies behind the corruption are
        unrecoverable)."""
        acks = hotframe.decode_acks(body)
        for msg_id, value, is_err in acks:
            fut = self._pending.get(msg_id)
            if fut is None or fut.done():
                continue
            if is_err:
                fut.set_exception(
                    value if isinstance(value, BaseException)
                    else RpcError(str(value)))
            else:
                fut.set_result(value)

    def _encode_hot_call(self, hot: _HotSendState, spec: TaskSpec,
                         msg_id: int) -> bytes | None:
        """Hot-wire encoding of one PushTask, or None when the spec is
        not hot-eligible / the template cache is full (the caller falls
        back to the pickled frame).  A first-use template rides framed
        IMMEDIATELY ahead of its call in the same write, so it can
        never arrive late."""
        key = hotframe.template_key(spec)
        if key is None:
            hotframe.counters["fallback_ineligible"] += 1
            return None
        tid, is_new = hot.templates.intern(key)
        if tid is None:
            # Distinct from ineligible: the fix for THIS fallback is
            # raising the cache bound, not reshaping specs.
            hotframe.counters["fallback_cache_full"] += 1
            return None
        call = _encode_hot_frame(hotframe.encode_call(tid, spec, msg_id))
        if is_new:
            return _encode_hot_frame(hotframe.encode_template(tid, spec)) \
                + call
        return call

    def _pop_pending(self, fut) -> None:
        # Cleanup on any terminal state — including cancellation by a
        # wait_for timeout — so abandoned calls never leak their entry.
        self._pending.pop(fut._art_msg_id, None)

    def _register_pending(self) -> tuple[int, asyncio.Future]:
        msg_id = next(self._counter)
        fut = self._io.loop.create_future()
        fut._art_msg_id = msg_id
        # The connection this call belongs to (both registration sites
        # run unsuspended after the writer check / _ensure_connected):
        # teardown fails only its own connection's futures with it.
        fut._art_writer = self._writer
        self._pending[msg_id] = fut
        fut.add_done_callback(self._pop_pending_cb)
        return msg_id, fut

    def _encode_request(self, method: str, payload: Any,
                        msg_id: int) -> tuple[bytes, Any]:
        """(frame bytes, writer-tag) for one request — the ONE place
        that decides hot vs pickled encoding, shared by the sync and
        async send paths so they cannot desynchronize.  The tag is the
        connection a hot frame was encoded for (None for pickled)."""
        t0 = time.perf_counter_ns()
        if method == "PushTask" and type(payload) is TaskSpec:
            hot = self._hot
            if hot is not None and hot.writer is self._writer:
                frame = self._encode_hot_call(hot, payload, msg_id)
                if frame is not None:
                    _wire_account(method, "send", len(frame),
                                  time.perf_counter_ns() - t0,
                                  self.wire_stats)
                    return frame, hot.writer
        frame = _encode_frame((_REQ, msg_id, method, payload))
        _wire_account(method, "send", len(frame),
                      time.perf_counter_ns() - t0, self.wire_stats)
        return frame, None

    def try_send_deferred(self, method: str, payload: Any):
        """Sync defer-enqueue fast path (io-loop only): on an
        established, chaos-free connection this is the whole per-call
        send — no coroutine, no awaits.  Returns the reply future, or
        None when the slow path must run (not connected, or chaos
        injection is configured — the async path owns those)."""
        if self._chaos_active:
            return None
        writer = self._writer
        if writer is None or writer.is_closing():
            return None
        msg_id, fut = self._register_pending()
        frame, tag = self._encode_request(method, payload, msg_id)
        self._outbox.append((frame, fut, tag))
        return fut

    async def send_request(self, method: str, payload: Any = None,
                           defer: bool = False) -> asyncio.Future:
        """Write the request frame now; return the future for the reply.

        Callers needing strict send ordering (e.g. per-actor task queues)
        await this sequentially and await the reply futures separately, so
        ordering and pipelining compose.

        ``defer=True`` queues the frame in the client outbox instead of
        writing; a later :meth:`flush_deferred` ships every queued frame
        in one transport write (one syscall for a pipeline burst).
        """
        if self._chaos.should_fail(method):
            raise RpcConnectionError(f"[chaos] injected failure for {method}")
        delay = self._chaos.delay_for(method)
        if delay > 0:
            await asyncio.sleep(delay)
        await self._ensure_connected()
        msg_id, fut = self._register_pending()
        frame, writer_tag = self._encode_request(method, payload, msg_id)
        if defer:
            self._outbox.append((frame, fut, writer_tag))
            return fut
        await self._write_frame(frame)
        return fut

    async def _write_frame(self, frame: bytes):
        """Write with flow control: the common case (transport buffer
        under the threshold) is a plain non-awaiting write; only a
        backed-up transport pays the drain await (and its lock)."""
        writer = self._writer
        if writer is None:
            raise RpcConnectionError(f"connection to {self.address} lost")
        writer.write(frame)
        if writer.transport.get_write_buffer_size() > _DRAIN_THRESHOLD:
            async with self._write_lock:
                writer = self._writer
                if writer is None:
                    raise RpcConnectionError(
                        f"connection to {self.address} lost")
                await writer.drain()

    async def flush_deferred(self):
        """Ship all defer-queued frames in a single transport write.

        Hot frames that were encoded for a connection that has since
        turned over are failed instead of shipped — their template ids
        mean nothing to the new peer (the caller's retry path re-pushes
        them, re-encoded against the fresh connection)."""
        if not self._outbox:
            return
        entries, self._outbox = self._outbox, []
        writer = self._writer
        stale = [e for e in entries
                 if e[2] is not None and e[2] is not writer]
        if stale:
            self._fail_entries(stale)
            entries = [e for e in entries
                       if e[2] is None or e[2] is writer]
            if not entries:
                return
        try:
            await self._write_frame(entries[0][0] if len(entries) == 1
                                    else b"".join(f for f, _, _ in entries))
        except BaseException:
            self._fail_entries(entries)
            raise

    def discard_deferred(self, writer=None):
        """Drop never-shipped deferred frames, failing their futures —
        replaying them on a later (re)connection would double-execute
        tasks that the caller already rerouted elsewhere.  With
        ``writer``, only entries registered against that connection are
        dropped: a stale read loop racing a completed reconnect must
        not fail the new connection's deferred traffic."""
        if writer is None:
            entries, self._outbox = self._outbox, []
        else:
            entries = [e for e in self._outbox
                       if e[1]._art_writer is writer]
            if entries:
                self._outbox = [e for e in self._outbox
                                if e[1]._art_writer is not writer]
        self._fail_entries(entries)

    def _fail_entries(self, entries):
        err = RpcConnectionError(
            f"request to {self.address} was never sent")
        for _frame, fut, _tag in entries:
            if not fut.done():
                fut.set_exception(err)

    async def call_async(
        self, method: str, payload: Any = None, timeout: float | None = None
    ) -> Any:
        # Tracing fast path: one contextvar read.  Calls made inside a
        # sampled trace (the caller's context rides into this coroutine
        # via the event-loop context copy) record a client span with a
        # serialize/wire stage split; everything else takes the bare
        # path below untouched.
        ctx = _trace_current()
        if ctx is not None:
            return await self._traced_call(ctx, method, payload, timeout)
        fut = await self.send_request(method, payload)
        return await self._await_reply(fut, method, timeout)

    async def _await_reply(self, fut, method: str,
                           timeout: float | None) -> Any:
        """ONE deadline semantic for traced and untraced calls:
        ``timeout <= 0`` is the explicit no-deadline escape hatch
        (long-running task pushes); None takes the config default."""
        if timeout is None:
            timeout = global_config().rpc_call_timeout_s
        if timeout <= 0:
            return await fut
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError as e:
            raise RpcTimeoutError(
                f"{method} to {self.address} timed out") from e

    async def _traced_call(self, ctx, method: str, payload: Any,
                           timeout: float | None) -> Any:
        """call_async under a sampled trace context: record an
        ``rpc:{method}`` client span (stages: serialize = encode+write,
        wire = flight + server time) and feed the
        ``art_rpc_latency_s{method,stage}`` histogram with the trace id
        as its exemplar."""
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        t_wall = time.time()
        t0 = time.perf_counter()
        t_sent = t0
        err = False
        try:
            fut = await self.send_request(method, payload)
            t_sent = time.perf_counter()
            return await self._await_reply(fut, method, timeout)
        except BaseException:
            err = True
            raise
        finally:
            t_end = time.perf_counter()
            stages = {"serialize": t_sent - t0, "wire": t_end - t_sent}
            sid = tracing_plane.record_span(
                ctx, f"rpc:{method}", ts=t_wall, dur_s=t_end - t0,
                stages=stages,
                attrs={"method": method, "peer": self.address},
                error=err, service="rpc-client")
            if sid is not None:
                tracing_plane.record_rpc(method, stages, ctx.trace_id)

    async def oneway_async(self, method: str, payload: Any = None) -> None:
        await self._ensure_connected()
        t0 = time.perf_counter_ns()
        frame = _encode_frame((_ONEWAY, -1, method, payload))
        _wire_account(method, "send", len(frame),
                      time.perf_counter_ns() - t0, self.wire_stats)
        await self._write_frame(frame)

    async def oneway_many(self, items) -> None:
        """Ship a batch of ``(method, payload)`` oneways in one
        transport write (the coalesced refcount/publish path: a burst
        of per-call notifications costs one syscall, not N)."""
        await self._ensure_connected()
        frames = []
        for method, payload in items:
            t0 = time.perf_counter_ns()
            frame = _encode_frame((_ONEWAY, -1, method, payload))
            _wire_account(method, "send", len(frame),
                          time.perf_counter_ns() - t0, self.wire_stats)
            frames.append(frame)
        await self._write_frame(b"".join(frames))

    def call(self, method: str, payload: Any = None,
             timeout: float | None = None, retries: int = 0) -> Any:
        """Blocking call from any non-io thread, with connection retries."""
        from ant_ray_tpu_torch._lint.lockcheck import note_blocking  # noqa: PLC0415

        # Runtime evidence for the static blocking-under-lock rule: if
        # the calling thread holds an instrumented lock across this
        # round trip, lockcheck reports the hold with its stack.
        note_blocking(f"RpcClient.call:{method}")
        attempt = 0
        while True:
            try:
                return self._io.run_coro(
                    self.call_async(method, payload, timeout)
                )
            except RpcConnectionError:
                attempt += 1
                if attempt > retries:
                    raise
                time.sleep(min(0.1 * 2 ** attempt, 2.0))

    def close(self):
        self._closed = True
        writer = self._writer
        if writer is not None:
            self._io.call_soon(writer.close)
            self._writer = None


class ClientPool:
    """Shared RpcClients keyed by address (ref: rpc client pools)."""

    def __init__(self):
        self._clients: dict[str, RpcClient] = {}
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._lock = make_lock("rpc.client_pool")

    def get(self, address: str) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
            if client is None or client._closed:
                if "," in address:
                    # A comma-joined replica list is a GCS HA spec: the
                    # pool hands back a leader-aware router with the
                    # RpcClient call surface, so every existing
                    # ``pool.get(gcs_address)`` call site gains
                    # redirect-following + re-resolve failover without
                    # changing.  (Import here: gcs_client imports this
                    # module.)
                    from ant_ray_tpu_torch._private.gcs_client import (  # noqa: PLC0415
                        GcsRouter,
                    )

                    client = GcsRouter(address, self)
                else:
                    client = RpcClient(address)
                self._clients[address] = client
            return client

    def invalidate(self, address: str) -> None:
        with self._lock:
            client = self._clients.pop(address, None)
        if client is not None:
            client.close()

    def close_all(self):
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
