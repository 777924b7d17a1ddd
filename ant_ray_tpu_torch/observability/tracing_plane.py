"""Request-level distributed tracing plane.

What the post-hoc task-event derivation in ``util/tracing.py`` cannot
see is a REQUEST: a serve call that fans out through a handle → replica
→ nested actor tasks → object pulls crosses four processes and none of
the driver-local task events link them.  This module is the Dapper-style
answer built native to our wire protocol:

* a W3C-traceparent-shaped :class:`TraceContext` (``trace_id``,
  ``span_id``, ``sampled``) is MINTED at every ingress — a serve
  HTTP/gRPC request, ``handle.call``, a driver ``.remote()`` — and
  PROPAGATED through request metadata (``TaskSpec.trace_ctx``, serve
  request meta, ``EnsureLocal``/``LeaseWorker`` payload ``trace`` keys)
  so every downstream hop records a child span;
* spans land in a per-process **flight recorder**: two bounded
  GIL-atomic rings (``collections.deque`` appends — no lock on the hot
  path), one for head-sampled spans and a separate one for force-sampled
  error/shed spans so a wrapping ring can never evict the evidence of a
  failure;
* sampled spans batch-publish best-effort to the GCS ``SpanEventsAdd``
  ring (the step-events idiom: oneway, dropped outside a cluster), where
  ``GET /api/trace/{trace_id}``, the Perfetto timeline and the OTLP
  exporters read them back;
* sampled RPCs additionally observe ``art_rpc_latency_s{method,stage}``
  histograms whose exemplars carry the trace id (OpenMetrics practice:
  the histogram names the slow bucket, the exemplar names a trace that
  landed in it).

Cost model (enforced by ``benchmarks/microbench.py`` at
``trace_overhead_unsampled_ns`` < 2 µs): the unsampled path is one
contextvar read, one coin flip amortized into the mint, and — when a
span block is entered at all — two ``perf_counter`` reads and a small
``__slots__`` object, with nothing recorded.  Head sampling is decided
once at mint (``trace_sample_rate``); the sampled flag rides the context
so every downstream hop agrees without re-flipping.
"""

from __future__ import annotations

import atexit
import contextvars
import os
import random
import threading
import time
from collections import deque

from ant_ray_tpu_torch._private.config import global_config

_PID = os.getpid()
_NODE_ID = os.environ.get("ART_NODE_ID", "")[:12]


def set_node_id(node_id_hex: str) -> None:
    """Fix this process's node identity on recorded spans.  Workers get
    it from the ART_NODE_ID env; the node daemon (which mints the ids)
    calls this at registration."""
    global _NODE_ID
    _NODE_ID = (node_id_hex or "")[:12]

_FLUSH_AGE_S = 1.0


class TraceContext:
    """W3C-traceparent-shaped identity of one request: 32-hex trace id,
    16-hex span id of the CURRENT span, and the head-sampling verdict.
    Immutable; ``child()`` mints a fresh span id under the same trace.
    Picklable so contexts survive handles/specs crossing processes."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id,
                            f"{random.getrandbits(64):016x}",
                            self.sampled)

    def to_wire(self) -> tuple:
        return (self.trace_id, self.span_id, self.sampled)

    @classmethod
    def from_wire(cls, wire) -> "TraceContext | None":
        if not wire:
            return None
        return cls(wire[0], wire[1], bool(wire[2]))

    def __reduce__(self):
        return (TraceContext, (self.trace_id, self.span_id, self.sampled))

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"TraceContext({self.trace_id[:8]}…/{self.span_id}, "
                f"sampled={self.sampled})")


_current: "contextvars.ContextVar[TraceContext | None]" = \
    contextvars.ContextVar("art_trace_ctx", default=None)


def current() -> TraceContext | None:
    """The active trace context in this thread/task, or None."""
    return _current.get()


def current_sampled() -> TraceContext | None:
    """Fast-path accessor: the active context only when sampled (the
    one contextvar read the RPC hot path pays)."""
    ctx = _current.get()
    if ctx is not None and ctx.sampled:
        return ctx
    return None


def mint(sampled: bool | None = None) -> TraceContext:
    """Mint a ROOT context at an ingress.  Head sampling: one coin flip
    against ``trace_sample_rate``; ids are generated even for unsampled
    contexts so a force-sampled error span downstream still has a trace
    identity to hang off.  Request-scale ingresses (serve) use this;
    the per-task hot path uses :func:`maybe_mint`."""
    if sampled is None:
        rate = global_config().trace_sample_rate
        sampled = rate > 0 and random.random() < rate
    return TraceContext(f"{random.getrandbits(128):032x}",
                        f"{random.getrandbits(64):016x}", sampled)


def maybe_mint() -> TraceContext | None:
    """Hot-path ingress mint (driver ``.remote()``): flip the
    head-sampling coin FIRST and generate ids only on a hit — the
    unsampled common case costs one RNG draw and allocates nothing."""
    rate = global_config().trace_sample_rate
    if rate <= 0.0 or random.random() >= rate:
        return None
    return mint(sampled=True)


def set_current(ctx: TraceContext | None):
    return _current.set(ctx)


def reset(token) -> None:
    _current.reset(token)


class use:
    """``with tracing_plane.use(ctx):`` — scope a context (reentrant:
    each instance owns its token)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx

    def __enter__(self):
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


# ------------------------------------------------------- flight recorder

class FlightRecorder:
    """Per-process bounded span store, always on.

    Two rings: head-sampled spans wrap freely; force-sampled spans
    (errors, sheds) live in their own ring so a burst of healthy
    traffic can never push the evidence of a failure out of memory.
    ``deque.append`` is GIL-atomic — the record path takes no lock."""

    def __init__(self, size: int | None = None):
        if size is None:
            size = max(64, int(global_config().flight_recorder_size))
        self.size = size
        self._ring: deque = deque(maxlen=size)
        self._forced: deque = deque(maxlen=max(64, size // 4))
        # publish batch (sampled spans only), flushed size/age-triggered
        self._pending: list = []
        self._pending_lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._flusher_started = False

    def record(self, span: dict, *, forced: bool = False,
               publish: bool = True) -> None:
        (self._forced if forced else self._ring).append(span)
        if not publish:
            return
        flush_now = False
        with self._pending_lock:
            self._pending.append(span)
            now = time.monotonic()
            if (len(self._pending)
                    >= global_config().trace_publish_batch
                    or now - self._last_flush > _FLUSH_AGE_S):
                flush_now = True
            if not self._flusher_started:
                self._flusher_started = True
                atexit.register(self.flush)
                threading.Thread(target=self._flush_loop, daemon=True,
                                 name="art-trace-flush").start()
        if flush_now:
            self.flush()

    def _flush_loop(self) -> None:
        while True:
            time.sleep(_FLUSH_AGE_S)
            self.flush()

    def flush(self) -> None:
        """Batch-publish pending spans to the GCS span ring.  Best
        effort: outside a cluster the batch is dropped (the recorder
        stays a cheap local instrument).  Drivers/workers ship via the
        runtime's oneway channel; processes without one (the node
        daemon) install a publisher with :func:`set_publisher`."""
        with self._pending_lock:
            if not self._pending:
                return
            batch, self._pending = self._pending, []
            self._last_flush = time.monotonic()
        try:
            publisher = _publisher
            if publisher is not None:
                publisher(batch)
                return
            runtime = _runtime()
            if runtime is None:
                return
            runtime._send_oneway(runtime.gcs_address, "SpanEventsAdd",
                                 {"spans": batch})
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    def snapshot(self, limit: int = 0) -> list[dict]:
        """Ring contents (forced + sampled), start-time ordered."""
        spans = list(self._ring) + list(self._forced)
        spans.sort(key=lambda s: s.get("ts", 0.0))
        return spans[-limit:] if limit else spans

    def clear(self) -> None:
        self._ring.clear()
        self._forced.clear()
        with self._pending_lock:
            self._pending.clear()


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()
_publisher = None


def set_publisher(fn) -> None:
    """Install the span-batch publisher for processes that are not art
    drivers/workers (the node daemon ships through its own GCS client).
    ``fn(batch: list[dict])`` must be thread-safe and non-blocking."""
    global _publisher
    _publisher = fn


def recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def flush() -> None:
    if _recorder is not None:
        _recorder.flush()


def _runtime():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if not global_worker.connected:
        return None
    runtime = global_worker.runtime
    return runtime if hasattr(runtime, "_send_oneway") else None


# ----------------------------------------------------------- span record

def record_span(ctx, name: str, *, ts: float, dur_s: float,
                stages: dict | None = None, attrs: dict | None = None,
                error: bool = False, span_id: str | None = None,
                parent_id: str | None = None,
                service: str = "") -> str | None:
    """Record one completed span under ``ctx`` (a TraceContext or wire
    tuple).  Unsampled contexts record nothing UNLESS ``error`` — error
    and shed spans are force-sampled into the recorder's protected ring
    (and still published, so a 429's trace id is findable).  Returns the
    span id (for callers chaining children explicitly)."""
    if isinstance(ctx, tuple):
        ctx = TraceContext.from_wire(ctx)
    if ctx is None:
        return None
    forced = error and not ctx.sampled
    if not ctx.sampled and not error:
        return None
    sid = span_id or f"{random.getrandbits(64):016x}"
    span = {
        "trace_id": ctx.trace_id,
        "span_id": sid,
        "parent_id": parent_id if parent_id is not None else ctx.span_id,
        "name": name,
        "ts": ts,
        "dur_s": dur_s,
        "node_id": _NODE_ID,
        "pid": _PID,
    }
    if stages:
        span["stages"] = stages
    if attrs:
        span["attrs"] = attrs
    if error:
        span["error"] = True
    if forced:
        span["forced"] = True
    if service:
        span["service"] = service
    recorder().record(span, forced=forced)
    return sid


class _Noop:
    """Span no-op for code paths with no trace context at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Span:
    """Live span block.  Unsampled contexts pay two perf_counter reads
    and this allocation; nothing is recorded unless the block raises
    (force-sampled error span)."""

    __slots__ = ("_ctx", "_name", "_attrs", "_t0", "span_id")

    def __init__(self, ctx: TraceContext, name: str, attrs: dict | None):
        self._ctx = ctx
        self._name = name
        self._attrs = attrs
        self.span_id = None

    def set(self, **attrs) -> None:
        if self._attrs is None:
            self._attrs = attrs
        else:
            self._attrs.update(attrs)

    def __enter__(self):
        # One clock read on entry; the wall-clock start is derived at
        # exit only when something is actually recorded (the unsampled
        # no-error path pays two perf_counter reads total).
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        ctx = self._ctx
        # GeneratorExit is a consumer abandoning a stream mid-yield —
        # a normal ending, not failure evidence to force-sample.
        error = (exc_type is not None
                 and not issubclass(exc_type, GeneratorExit))
        if ctx.sampled or error:
            dur = time.perf_counter() - self._t0
            # artlint: disable=banned-apis — span `ts` is a cross-
            # process wire field: wall clock is what lets spans from
            # different hosts land on one timeline.
            self.span_id = record_span(
                ctx, self._name, ts=time.time() - dur, dur_s=dur,
                attrs=self._attrs, error=error)
        return False


def span(name: str, attrs: dict | None = None):
    """``with tracing_plane.span("object:pull"):`` — record a child
    span of the active context (no-op without one; force-sampled on
    error even when unsampled)."""
    ctx = _current.get()
    if ctx is None:
        return _NOOP
    return _Span(ctx, name, attrs)


class server_span:
    """Traced-server-handler scaffold: ONE implementation of the
    time-the-block / record-span-and-rpc-observation-in-finally shape
    the daemon's traced handlers share.  Usage::

        with tracing_plane.server_span(wire, "daemon:lease",
                                       "LeaseWorker") as sp:
            reply = await impl(payload)
            sp.attrs = {...}
            sp.error = "infeasible" in reply

    An exception inside the block marks the span as an error
    automatically (GeneratorExit excepted); ``attrs``/``error`` set by
    the block ride the recorded span."""

    __slots__ = ("_wire", "_name", "_method", "_service", "attrs",
                 "error", "_wall", "_t0")

    def __init__(self, wire, name: str, method: str,
                 service: str = "node-daemon"):
        self._wire = wire
        self._name = name
        self._method = method
        self._service = service
        self.attrs: dict | None = None
        self.error = False

    def __enter__(self):
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and not issubclass(exc_type,
                                                   GeneratorExit):
            self.error = True
        dur = time.perf_counter() - self._t0
        record_span(self._wire, self._name, ts=self._wall, dur_s=dur,
                    stages={"execute": dur}, attrs=self.attrs,
                    error=self.error, service=self._service)
        if self._wire:
            record_rpc(self._method, {"execute": dur}, self._wire[0])
        return False


# ----------------------------------------------- rpc latency histograms

_RPC_BOUNDARIES = [0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0]

_metric_recorder = None


def set_metric_recorder(fn) -> None:
    """Install the histogram-observation sender for processes without a
    worker runtime (the node daemon ships ``MetricRecord`` payloads
    through its own GCS client).  ``fn(payload: dict)`` must be
    thread-safe and non-blocking."""
    global _metric_recorder
    _metric_recorder = fn


def record_rpc(method: str, stages: dict, trace_id: str = "") -> None:
    """Observe ``art_rpc_latency_s{method,stage}`` for one sampled RPC.
    Emitted only for sampled requests — the sampling rate bounds the
    metric traffic, and every observation carries the trace id as an
    OpenMetrics exemplar so a slow bucket links to a concrete trace.

    Every process ships raw ``MetricRecord`` payloads to the GCS, which
    folds them into the histogram: the node daemon through its installed
    sender, drivers and workers through their runtime's oneway channel.
    (The JAX package aggregates in-process with ``util/metrics.py``
    ``Histogram`` first; that module is ROADMAP queue A item 6.2.)"""
    try:
        send = _metric_recorder
        if send is None:
            runtime = _runtime()
            if runtime is None:
                return

            def send(payload, runtime=runtime):
                runtime._send_oneway(runtime.gcs_address, "MetricRecord",
                                     payload)

        for stage, seconds in stages.items():
            payload = {
                "name": "art_rpc_latency_s", "type": "histogram",
                "value": float(seconds),
                "tags": {"method": method, "stage": stage},
                "description": "Per-stage RPC latency",
                "boundaries": _RPC_BOUNDARIES,
            }
            if trace_id:
                payload["exemplar"] = {
                    "labels": {"trace_id": trace_id},
                    "value": float(seconds), "ts": time.time()}
            send(payload)
    except Exception:  # noqa: BLE001 — observability must never fail a call
        pass


# ------------------------------------------------- method → plane table
#
# Every wire_schema METHODS entry must appear here (lint-enforced by
# tests/test_wire_schema.py): the plane label is the ``art_rpc_latency_s``
# aggregation axis a new RPC lands in, and the lint is what keeps a
# future RPC from shipping untraced — adding a method without deciding
# its plane fails CI.

RPC_METHOD_PLANES: dict[str, str] = {
    # ---- GCS control plane
    "RegisterNode": "control", "Heartbeat": "control",
    "GetAllNodes": "control", "ListNodes": "control",
    "GetScaleStats": "observability", "DrainNode": "control",
    "KVPut": "control", "KVGet": "control", "KVDel": "control",
    "KVTake": "control", "KVKeys": "control",
    "RegisterJob": "control", "CreateActor": "control",
    "GetActorInfo": "control", "WaitActorAlive": "control",
    "GetNamedActor": "control", "KillActor": "control",
    "ActorStateUpdate": "control", "WorkerDied": "control",
    "ObjectLocationAdd": "object", "ObjectLocationRemove": "object",
    "ObjectLocationsGet": "object", "FreeObject": "object",
    "SelectNode": "control", "ResourceDemands": "control",
    "AutoscalerHeartbeat": "control", "AutoscalingEnabled": "control",
    "ClusterResources": "control", "AvailableResources": "control",
    "CreatePlacementGroup": "control", "GetPlacementGroup": "control",
    "RemovePlacementGroup": "control", "ListPlacementGroups": "control",
    "ListActors": "control", "ListObjects": "object",
    "MetricRecord": "observability", "MetricsGet": "observability",
    "MetricsExpire": "observability",
    "CreateVirtualCluster": "control", "RemoveVirtualCluster": "control",
    "UpdateVirtualCluster": "control", "ListVirtualClusters": "control",
    "SetJobVirtualCluster": "control", "GetJobVirtualCluster": "control",
    "InsightRecord": "observability", "InsightGet": "observability",
    "TaskEventsAdd": "observability", "TaskEventsGet": "observability",
    "ListTasks": "observability", "GetTask": "observability",
    "SummarizeTasks": "observability", "ListJobs": "observability",
    "StepEventsAdd": "observability", "StepEventsGet": "observability",
    "SpanEventsAdd": "observability", "SpanEventsGet": "observability",
    "CpuProfileAdd": "observability", "CpuProfileGet": "observability",
    "SubPoll": "control", "PublishLogs": "observability",
    "ExportEventsGet": "observability", "Shutdown": "control",
    "GetHaView": "control",
    # ---- node daemon
    "LeaseWorker": "scheduling", "ReturnWorker": "scheduling",
    "RegisterWorker": "scheduling", "StartActorWorker": "scheduling",
    "KillActorWorker": "scheduling", "WorkerBlocked": "scheduling",
    "WorkerUnblocked": "scheduling", "PrepareBundle": "scheduling",
    "CommitBundle": "scheduling", "ReturnBundle": "scheduling",
    "CreateBuffer": "object", "SealBuffer": "object",
    "SealObject": "object", "DeleteObject": "object",
    "ContainsObject": "object", "LocateObject": "object",
    "ReadChunk": "object", "ReadChunkRaw": "object",
    "EnsureLocal": "object", "ReadDone": "object", "RenewPins": "object",
    "GetNodeInfo": "control", "NotifyDrain": "control",
    "DebugResources": "observability", "GetNodeMetrics": "observability",
    "GetStoreStats": "observability", "GetSyncStats": "observability",
    "ListObjectStats": "observability",
    "GetTransferStats": "observability",
    "GetFlightRecorder": "observability",
    "ListLogs": "observability", "ReadLog": "observability",
    # ---- worker / owner
    "PushTask": "execution", "CancelTask": "execution",
    "InstantiateActor": "execution", "Ping": "control",
    "GetObject": "object", "GetObjectStatus": "object",
    "GetObjectStatusBatch": "object", "WaitObjects": "object",
    "GetObjectInfo": "object", "GetOwnedRefInfo": "observability",
    "BorrowAdd": "object",
    "BorrowRemove": "object", "ReconstructObject": "object",
    "StreamItem": "execution", "DeviceTensorFetch": "object",
    "DeviceTensorFree": "object", "DeviceTensorSendVia": "object",
    # ---- node agent
    "BuildRuntimeEnv": "scheduling", "AgentListLogs": "observability",
    "AgentReadLog": "observability", "AgentMetrics": "observability",
    "AgentStats": "observability", "AgentDeviceStats": "observability",
    "AgentProfile": "observability", "GetAgentInfo": "control",
    # ---- store service (HA)
    "StorePut": "storage", "StoreGet": "storage",
    "StoreDelete": "storage", "StoreLoadTable": "storage",
    "LeaseAcquire": "storage", "LeaseRenew": "storage",
    "LeaseRelease": "storage", "LeaseInfo": "storage",
}


# ------------------------------------------------------------- tree view

def span_tree(spans: list[dict]) -> list[dict]:
    """Fold flat span dicts into a forest: each node is the span dict
    plus a ``children`` list (start-time ordered).  Spans whose parent
    is absent from the set (the ingress root, or a truncated ring)
    surface as roots — a partial trace still renders."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for node in sorted(by_id.values(), key=lambda s: s.get("ts", 0.0)):
        parent = by_id.get(node.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots
