"""Per-node daemon ("raylet"-equivalent).

Role of the reference's raylet (ref: src/ray/raylet/node_manager.h:134,
worker_pool.h:285, local_object_manager.h): owns the node's worker pool and
shared-memory object store, grants worker leases against a local resource
view with spillback hints to other nodes, pulls remote objects in chunks,
monitors worker processes, and heartbeats the node's resource availability
to the GCS.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.ids import NodeID, ObjectID, WorkerID
from ant_ray_tpu_torch._private.object_store import ObjectStore, default_store_capacity
from ant_ray_tpu_torch._private.protocol import (
    ClientPool,
    IoThread,
    RawReply,
    RpcConnectionError,
    RpcError,
    RpcServer,
    RpcTimeoutError,
    _spawn,
)
from ant_ray_tpu_torch._private.specs import ACTOR_DEAD, ActorSpec, NodeInfo

logger = logging.getLogger(__name__)


def _bundle_fits(bundle: dict, demand: dict) -> bool:
    """Whole-demand-within-bundle-capacity (shared by the prefetch gate
    and the grant/infeasible decision — they must never diverge)."""
    return all(bundle["resources"].get(k, 0.0) >= v
               for k, v in demand.items())


def _enable_subreaper() -> bool:
    """PR_SET_CHILD_SUBREAPER: a dead worker's user subprocesses
    re-parent to this daemon instead of init, so they can be detected
    and killed rather than leak (ref: src/ray/util/subreaper.h).
    Linux-only; returns False where unavailable."""
    if not sys.platform.startswith("linux"):
        return False
    try:
        import ctypes  # noqa: PLC0415

        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_CHILD_SUBREAPER = 36
        return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except Exception:  # noqa: BLE001 — best-effort hardening
        return False


class _HolderMiss(RuntimeError):
    """A GCS-listed holder no longer has the object (stale location)."""


class _NoViableHolder(RuntimeError):
    """Every GCS-listed holder missed the size probe (stale locations)
    or was unreachable — the pull round found nothing to pull from.
    ``any_unreachable`` distinguishes "all copies verifiably gone"
    (every miss retracted) from "holders exist but can't be reached
    right now" — only the former may feed the no-holders fail-fast that
    triggers lineage reconstruction."""

    def __init__(self, what: str, any_unreachable: bool = False):
        super().__init__(what)
        self.any_unreachable = any_unreachable

IDLE, LEASED, ACTOR, STARTING = "idle", "leased", "actor", "starting"

# Pin tokens for raw-RPC chunk serving (distinct namespace from the
# daemon's integer pin-lease tokens and the bulk channel's tokens).
_raw_serve_tokens = itertools.count()


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    proc: subprocess.Popen
    address: str = ""
    state: str = STARTING
    lease_resources: dict[str, float] = field(default_factory=dict)
    lease_pg: tuple | None = None        # (pg_id, bundle_index) if any
    lease_owner: str = ""                # lessee's core-service address
    actor_spec: ActorSpec | None = None
    job_id: object | None = None         # last job served (log scoping)
    blocked: bool = False
    env_key: str = ""                    # runtime-env pool identity
    registered: asyncio.Event = field(default_factory=asyncio.Event)


class NodeManager:
    def __init__(self, gcs_address: str, resources: dict[str, float],
                 session_dir: str, host: str = "127.0.0.1", port: int = 0,
                 labels: dict[str, str] | None = None):
        self.node_id = NodeID.from_random()
        self._gcs_address = gcs_address
        self._server = RpcServer(host, port)
        self._clients = ClientPool()
        self._io = IoThread.get()
        self._session_dir = session_dir
        # Auto-detected node labels merged under explicit labels — this
        # node process runs on the host being described, so detection
        # happens here, not in the launcher.  The GPU detector reports
        # none yet (GPU placement is ROADMAP queue A item 9), so there is
        # no counterpart of the TPU slice-head resource.
        from ant_ray_tpu_torch._private.accelerators import gpu as _gpu  # noqa: PLC0415

        self._labels = {**_gpu.node_labels(), **(labels or {})}

        cfg = global_config()
        store_capacity = cfg.object_store_memory or default_store_capacity()
        store_dir = os.path.join(
            "/dev/shm" if os.path.isdir("/dev/shm") else session_dir,
            f"art_{uuid.uuid4().hex[:8]}_{self.node_id.hex()[:8]}")
        spill_dir = (os.path.join(session_dir,
                                  f"spill_{self.node_id.hex()[:8]}")
                     if cfg.enable_object_spilling else None)
        self.store = ObjectStore(store_dir, store_capacity,
                                 on_delete=self._on_store_delete,
                                 spill_dir=spill_dir)

        self._total = dict(resources)
        self._available = dict(resources)
        # (pg_id, bundle_index) -> {"resources", "available", "committed"}
        self._bundles: dict[tuple, dict] = {}
        self._workers: dict[WorkerID, WorkerHandle] = {}
        # Spawned-but-unregistered workers: counted against the pool cap
        # so N concurrent lease requests can't each spawn (check-then-
        # spawn overshoot — a burst of leases on a small node must queue
        # for the pool, not fork a process storm).
        self._starting_workers = 0
        self._lease_event = asyncio.Event()
        self._max_workers = int(
            cfg.max_workers_per_node or max(1, int(resources.get("CPU", 1))))
        self._tasks: list = []
        self._stopping = False
        # object_id -> {pin_token: lease_expiry}, one per outstanding
        # arena read pin (see _locate_pinned / _reap_expired_pins).
        # Tokens let ReadDone/RenewPin address a specific reader's pin,
        # so a short-TTL reader finishing can't consume a long-lived
        # zero-copy reader's lease.
        self._pin_leases: dict[ObjectID, dict[int, float]] = {}
        self._next_pin_token = 1
        # Versioned-sync observability + early-send wakeup (see
        # _heartbeat_loop; ref: ray_syncer resource-view component).
        self.sync_stats = {"beats": 0, "views_sent": 0, "failures": 0}
        # In-flight lease-dep prefetch pulls, coalesced per object.
        self._prefetching: dict[ObjectID, asyncio.Task] = {}
        self._sync_wakeup = asyncio.Event()
        # Broadcast-serving chunk cache (ref: PushManager chunk dedup,
        # src/ray/object_manager/push_manager.h:28 — redesigned for the
        # pull-driven plane: N nodes fetching one object each read every
        # chunk from the holder, so the holder memoizes the chunk bytes
        # and pays ONE store read per chunk per broadcast, not N).
        self._chunk_cache: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._chunk_cache_bytes = 0
        # Guards the chunk cache: served from the io loop (RPC chunk
        # reads) AND from bulk-transfer handler threads.
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._chunk_cache_lock = make_lock("daemon.chunk_cache")
        # Pull admission quota: bytes of in-flight inbound transfers
        # (ref: pull_manager.h:50 num_bytes_being_pulled quota) — callers
        # queue instead of pulling a dataset larger than memory at once.
        self._pull_bytes_inflight = 0
        self._pull_quota_cv: asyncio.Condition = asyncio.Condition()
        # pull_bytes_bulk vs pull_bytes_relayed split the pull volume by
        # path: holder-direct bulk-socket chunks vs chunks relayed
        # through the daemon RPC loop (ReadChunkRaw/ReadChunk fallback).
        # Their ratio is the `object_pull_relayed_fraction` gauge — the
        # "before" number for the owner-direct-pull plane (ROADMAP item
        # 2), which should drive it toward ~0.
        self.transfer_stats = {"chunk_reads": 0, "chunk_cache_hits": 0,
                               "quota_waits": 0, "stripe_cache_hits": 0,
                               "stripe_pulls": 0, "stripe_failovers": 0,
                               "holder_failures": 0, "pull_bytes": 0,
                               "pull_bytes_bulk": 0,
                               "pull_bytes_relayed": 0}
        # Holder-side log of served transfer-chunk requests (bounded),
        # for stripe tests/debugging: (object_hex, offset, length).
        self._chunk_read_log: deque = deque(maxlen=8192)
        # terminated-but-unreaped workers (retired for env mismatch)
        self._retired_procs: list[subprocess.Popen] = []
        # job_id -> (allowed_here, expires_at): virtual-cluster fencing
        self._vc_cache: dict = {}
        self.address = ""
        self._disk_full = False
        # Drain state (announced departure — TPU maintenance event,
        # SIGTERM, operator NotifyDrain): this node takes no NEW leases
        # but keeps serving its current work until it actually exits.
        self._draining = False
        self._drain_reason = ""
        self._drain_deadline_ts = 0.0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        self._server.routes({
            "RegisterWorker": self._register_worker,
            "LeaseWorker": self._lease_worker,
            "ReturnWorker": self._return_worker,
            "WorkerBlocked": self._worker_blocked,
            "WorkerUnblocked": self._worker_unblocked,
            "StartActorWorker": self._start_actor_worker,
            "KillActorWorker": self._kill_actor_worker,
            "PrepareBundle": self._prepare_bundle,
            "CommitBundle": self._commit_bundle,
            "ReturnBundle": self._return_bundle,
            "SealObject": self._seal_object,
            "CreateBuffer": self._create_buffer,
            "SealBuffer": self._seal_buffer,
            "LocateObject": self._locate_object,
            "EnsureLocal": self._ensure_local,
            "ReadDone": self._read_done,
            "RenewPins": self._renew_pins,
            "ReadChunk": self._read_chunk,
            "DeleteObject": self._delete_object,
            "ContainsObject": self._contains_object,
            "GetNodeInfo": self._get_node_info,
            "GetAgentInfo": self._get_agent_info,
            "NotifyDrain": self._notify_drain,
            "DebugResources": self._debug_resources,
            "GetSyncStats": self._get_sync_stats,
            "GetStoreStats": self._get_store_stats,
            "ListObjectStats": self._list_object_stats,
            "GetNodeMetrics": self._get_node_metrics,
            "GetFlightRecorder": self._get_flight_recorder,
            "GetTransferStats": self._get_transfer_stats,
            "ListLogs": self._list_logs,
            "ReadLog": self._read_log,
            "Shutdown": self._shutdown_rpc,
        })
        # Sync fast route: the raw reply is written inline (no task
        # boundary), so an arena view can be served zero-copy — nothing
        # can evict/recycle the range before the transport consumes it.
        self._server.fast_route("ReadChunkRaw", self._read_chunk_raw)
        # Bulk data channel (transfer.py): holders advertise its port
        # via LocateObject probes; pullers that see one drain chunks
        # over blocking sockets instead of the control-plane RPC loop.
        from ant_ray_tpu_torch._private.transfer import BulkServer  # noqa: PLC0415

        self._bulk = BulkServer(self, host=self._server._host)
        self._bulk_port = self._bulk.start()
        self.address = self._server.start()
        fut = asyncio.run_coroutine_threadsafe(self._register(), self._io.loop)
        fut.result(timeout=30)
        self._tasks.append(asyncio.run_coroutine_threadsafe(
            self._heartbeat_loop(), self._io.loop))
        self._tasks.append(asyncio.run_coroutine_threadsafe(
            self._monitor_workers_loop(), self._io.loop))
        if global_config().log_to_driver:
            self._tasks.append(asyncio.run_coroutine_threadsafe(
                self._log_stream_loop(), self._io.loop))
        self._subreaper_enabled = _enable_subreaper()
        self._start_agent()
        # cgroup v2 isolation (opt-in; ref: src/ray/common/cgroup2/ —
        # workers live in a sibling cgroup with a collective memory cap
        # so one blow-up can't take the daemon down).
        self._cgroups = None
        cfg = global_config()
        if cfg.enable_cgroups:
            from ant_ray_tpu_torch._private.cgroup2 import CgroupManager  # noqa: PLC0415

            if CgroupManager.available(cfg.cgroup_root):
                mgr = CgroupManager(
                    os.path.basename(self._session_dir.rstrip("/"))
                    + "_" + self.node_id.hex()[:8],
                    root=cfg.cgroup_root,
                    workers_memory_max=cfg.cgroup_workers_memory_max,
                    workers_cpu_weight=cfg.cgroup_workers_cpu_weight)
                if mgr.setup():
                    mgr.add_system_process(os.getpid())
                    self._cgroups = mgr
                    logger.info("cgroup2 worker isolation active")
            else:
                logger.info("enable_cgroups set but no writable cgroup2 "
                            "tree; running without isolation")
        # The JAX package's daemon also runs a preemption watch, which
        # drains the node on a maintenance notice: a GPU host has no
        # notice source the port reads (ROADMAP queue A item 9).
        if global_config().fs_monitor_interval_s > 0:
            self._tasks.append(asyncio.run_coroutine_threadsafe(
                self._fs_monitor_loop(), self._io.loop))
        if global_config().memory_monitor_interval_s > 0:
            self._tasks.append(asyncio.run_coroutine_threadsafe(
                self._memory_monitor_loop(), self._io.loop))
        prestart = global_config().num_prestart_workers
        if prestart < 0:
            prestart = min(2, self._max_workers)
        for _ in range(min(prestart, self._max_workers)):
            self._io.run_coro(self._prestart_worker())
        # Fix this process's node identity on recorded spans (workers
        # inherit ART_NODE_ID via env; the daemon minted the id itself)
        # and give the recorder a publisher — the daemon is not an art
        # worker, so the default runtime-oneway channel is absent.
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        tracing_plane.set_node_id(self.node_id.hex())

        def _publish_spans(batch, manager=self):
            gcs = manager._clients.get(manager._gcs_address)
            asyncio.run_coroutine_threadsafe(
                gcs.oneway_async("SpanEventsAdd", {"spans": batch}),
                manager._io.loop)

        def _publish_metric(payload, manager=self):
            gcs = manager._clients.get(manager._gcs_address)
            asyncio.run_coroutine_threadsafe(
                gcs.oneway_async("MetricRecord", payload),
                manager._io.loop)

        tracing_plane.set_publisher(_publish_spans)
        tracing_plane.set_metric_recorder(_publish_metric)
        # Continuous CPU profiling: the daemon's sampler ships folded
        # stacks (and its wire-counter rollups) through the same
        # oneway-via-io-loop channel as the span publisher above.  An
        # instance profiler, not the module singleton — tests run
        # multiple daemons in one process.
        from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

        self._cpu_profiler = None
        if global_config().cpu_profile_hz > 0:
            def _publish_profile(record, manager=self):
                gcs = manager._clients.get(manager._gcs_address)
                asyncio.run_coroutine_threadsafe(
                    gcs.oneway_async("CpuProfileAdd",
                                     {"records": [record]}),
                    manager._io.loop)

            self._cpu_profiler = cpu_profiler.CpuProfiler(
                "daemon", publish_fn=_publish_profile,
                metric_fn=_publish_metric,
                node_id=self.node_id.hex()).start()
        logger.info("node %s listening on %s (resources=%s)",
                    self.node_id.hex()[:8], self.address, self._total)
        return self.address

    async def _prestart_worker(self):
        self._spawn_worker()

    def _node_info(self) -> NodeInfo:
        return NodeInfo(
            node_id=self.node_id,
            address=self.address,
            total_resources=dict(self._total),
            available_resources=dict(self._available),
            object_store_dir=self.store.directory,
            labels=dict(self._labels),
            draining=self._draining,
            drain_reason=self._drain_reason,
            drain_deadline=self._drain_deadline_ts,
        )

    async def _register(self):
        gcs = self._clients.get(self._gcs_address)
        await gcs.call_async("RegisterNode", self._node_info(), timeout=30)

    # ------------------------------------------------------ log monitor
    # (ref: python/ray/_private/log_monitor.py + the dashboard log
    # agent — here the node daemon itself serves its session logs, so
    # debugging worker N never needs ssh.)

    def _logs_dir(self) -> str:
        from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415

        return log_serving.logs_dir(self._session_dir)

    async def _list_logs(self, _payload):
        from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415

        return log_serving.list_logs(self._session_dir)

    async def _read_log(self, payload):
        from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415

        return log_serving.read_log(self._session_dir, payload)

    async def _log_stream_loop(self):
        """Tail worker logs and fan new USER lines out to drivers via
        GCS pubsub (ref: log_monitor.py — `print()` inside a task shows
        up on the driver console as `(worker=.. pid=..) line`).  System
        lines (the worker's own `[worker ...]` logging format) stay in
        the file but are not streamed."""
        offsets: dict[str, int] = {}
        last_job: dict[str, object] = {}
        # name -> file offset below which lines predate the last
        # observed job switch (ship those unscoped).
        unscoped_below: dict[str, int] = {}
        gcs = self._clients.get(self._gcs_address)
        logs_dir = self._logs_dir()
        while not self._stopping:
            await asyncio.sleep(0.25)
            entries = []
            try:
                names = [n for n in os.listdir(logs_dir)
                         if n.startswith("worker-") and n.endswith(".log")]
            except OSError:
                continue
            for name in names:
                path = os.path.join(logs_dir, name)
                try:
                    size = os.path.getsize(path)
                    pos = offsets.get(name, 0)
                    if size <= pos:
                        continue
                    with open(path, "rb") as f:
                        f.seek(pos)
                        chunk = f.read(min(size - pos, 1 << 20))
                except OSError:
                    continue
                # keep any trailing partial line for the next pass —
                # unless the read window is full and newline-free (one
                # giant line): flush the whole window or the tail would
                # re-read it forever.
                cut = chunk.rfind(b"\n")
                if cut >= 0:
                    advance = cut + 1          # skip the newline
                elif len(chunk) >= (1 << 20):
                    cut = advance = len(chunk)  # flush, lose no bytes
                else:
                    continue
                offsets[name] = pos + advance
                short = name[len("worker-"):-len(".log")]
                handle = next((h for h in self._workers.values()
                               if h.worker_id.hex().startswith(short)),
                              None)
                pid = handle.proc.pid if handle else None
                job = None
                if handle is not None:
                    if handle.actor_spec is not None and \
                            handle.actor_spec.job_id is not None:
                        job = handle.actor_spec.job_id.hex()
                    elif handle.job_id is not None:
                        job = handle.job_id.hex()
                # Lines buffered across a lease boundary may belong to
                # the PREVIOUS job: on a job switch, everything already
                # in the file (up to its current size) ships unscoped —
                # every driver prints it — rather than scoped to the
                # wrong job and filtered off the right driver's
                # console.  A backlog larger than one read window stays
                # unscoped until the offset catches up to the switch
                # point.
                prev = last_job.get(name)
                if prev is not None and job is not None and prev != job:
                    unscoped_below[name] = size
                if job is not None:
                    last_job[name] = job
                if pos < unscoped_below.get(name, 0):
                    job = None
                lines = [ln.decode("utf-8", "replace")
                         for ln in chunk[:cut].split(b"\n")
                         if ln and not ln.startswith(b"[worker ")]
                if lines:
                    entries.append({"worker": short, "pid": pid,
                                    "job_id": job, "lines": lines})
            if entries:
                try:
                    await gcs.call_async(
                        "PublishLogs",
                        {"node": self.node_id.hex()[:8],
                         "entries": entries}, timeout=10)
                except Exception:  # noqa: BLE001 — head restarting
                    pass

    async def _get_agent_info(self, _payload):
        proc = getattr(self, "_agent_proc", None)
        return {"address": getattr(self, "_agent_address", None),
                "alive": proc is not None and proc.poll() is None,
                "restarts": getattr(self, "_agent_restarts", 0)}

    async def _get_node_info(self, _payload):
        return self._node_info()

    # ---------------------------------------------------------- draining
    # (announced departures: a TPU maintenance event / preemption notice
    #  arrives MINUTES before the host dies — reacting to it is the
    #  difference between a planned checkpoint+migrate and a surprise
    #  gang kill.  Ref: the reference's DrainNode protocol.  The port
    #  drains on NotifyDrain and SIGTERM; it has no maintenance-event
    #  watcher yet.)

    def begin_drain(self, reason: str = "",
                    deadline_s: float | None = None) -> bool:
        """Enter DRAINING: stop taking new leases, announce to the GCS.
        Idempotent; returns True on the first transition."""
        if self._draining:
            return False
        cfg = global_config()
        if deadline_s is None or deadline_s <= 0:
            deadline_s = cfg.drain_deadline_s
        self._draining = True
        self._drain_reason = reason or "drain requested"
        # Wall clock BY DESIGN: the deadline crosses processes in the
        # DrainNode payload / NodeInfo.DrainDeadline (specs.py).
        self._drain_deadline_ts = time.time() + deadline_s
        self._sync_wakeup.set()      # propagate via the next heartbeat
        logger.warning("node %s draining (%s; deadline in %.0fs)",
                       self.node_id.hex()[:8], self._drain_reason,
                       deadline_s)

        async def _announce():
            gcs = self._clients.get(self._gcs_address)
            payload = {"node_id": self.node_id,
                       "reason": self._drain_reason,
                       "deadline": self._drain_deadline_ts}
            for attempt in range(10):  # outlasts a head restart
                try:
                    await gcs.call_async("DrainNode", payload, timeout=10)
                    return
                except Exception:  # noqa: BLE001 — head restarting
                    await asyncio.sleep(min(0.2 * (attempt + 1), 2.0))
            # The heartbeat view carries the flag anyway — the direct
            # RPC only makes propagation immediate.

        # Fire-and-forget: begin_drain runs ON the io loop (NotifyDrain
        # handler) as well as off it (signal handler, watcher) — a
        # blocking run_coro here would deadlock the former.
        asyncio.run_coroutine_threadsafe(_announce(), self._io.loop)
        return True

    async def _notify_drain(self, payload):
        """Operator/test surface: drain THIS node (cluster_utils.
        drain_node, autoscaler downscale, chaos harness)."""
        payload = payload or {}
        return self.begin_drain(payload.get("reason", ""),
                                payload.get("deadline_s"))

    async def _debug_resources(self, _payload):
        """Resource-ledger dump for `art stack`-style debugging: who
        holds what, which workers are blocked, and each bundle pool."""
        return {
            "available": dict(self._available),
            "bundles": {f"{k[0].hex() if hasattr(k[0], 'hex') else k[0]}"
                        f"#{k[1]}": {"capacity": dict(b["resources"]),
                                     "available": dict(b["available"])}
                        for k, b in self._bundles.items()},
            "workers": [{
                "worker_id": wid.hex() if hasattr(wid, "hex") else str(wid),
                "state": h.state,
                "blocked": h.blocked,
                "lease": dict(h.lease_resources or {}),
                "actor": (h.actor_spec.class_name
                          if h.actor_spec is not None and
                          hasattr(h.actor_spec, "class_name")
                          else (h.actor_spec.actor_id.hex()
                                if h.actor_spec is not None else None)),
                "actor_resources": (dict(h.actor_spec.resources)
                                    if h.actor_spec is not None else None),
            } for wid, h in self._workers.items()],
        }

    async def _get_sync_stats(self, _payload):
        return dict(self.sync_stats)

    async def _get_store_stats(self, _payload):
        return {"used": self.store.used,
                "capacity": self.store.capacity,
                "spilled": self.store.spilled_bytes}

    async def _list_object_stats(self, _payload):
        """Per-object arena residency (size / pins / tier) plus this
        holder's chunk-cache footprint per object — the daemon half of
        the memory-attribution join (`art memory`, /api/memory,
        /api/objects all read this; the GCS directory contributes
        locations + owner)."""
        objects = self.store.object_stats()
        with self._chunk_cache_lock:
            cache_by_oid: dict[str, int] = {}
            for (oid, _offset, _length), data in \
                    self._chunk_cache.items():
                hexid = oid.hex()
                cache_by_oid[hexid] = \
                    cache_by_oid.get(hexid, 0) + len(data)
        for entry in objects:
            entry["chunk_cache_bytes"] = cache_by_oid.get(
                entry["object_id"], 0)
        return {"node_id": self.node_id.hex(),
                "objects": objects,
                "store": {"used": self.store.used,
                          "capacity": self.store.capacity,
                          "spilled": self.store.spilled_bytes}}

    async def _get_flight_recorder(self, payload):
        """This daemon process's flight-recorder ring (always on): the
        live spans — including force-sampled error spans — even when
        the batch publisher lags or the GCS ring wrapped.  The
        dashboard's ``GET /api/flightrecorder?node_id=`` lands here."""
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        limit = int((payload or {}).get("limit", 0) or 0)
        return {"node_id": self.node_id.hex(),
                "spans": tracing_plane.recorder().snapshot(limit)}

    async def _get_node_metrics(self, _payload):
        """Per-node gauges for the head's /metrics aggregation (role of
        the reference's per-node metrics agents, dashboard/agent.py:24 +
        _private/metrics_agent.py — the daemon exports its own numbers
        over RPC, no extra agent process per node)."""
        series = [
            ("art_node_store_used_bytes", self.store.used,
             "object store bytes in use"),
            ("art_node_store_capacity_bytes", self.store.capacity,
             "object store capacity"),
            ("art_node_store_spilled_bytes", self.store.spilled_bytes,
             "bytes spilled to disk"),
            ("art_node_workers", len(self._workers),
             "registered workers"),
            ("art_node_read_pins", len(self._pin_leases),
             "objects held by read pins"),
            ("art_node_heartbeat_failures_total",
             self.sync_stats["failures"],
             "heartbeat sends that failed (flapping GCS link)"),
        ]
        try:
            load1 = os.getloadavg()[0]
            series.append(("art_node_load1", load1, "1m load average"))
        except OSError:  # pragma: no cover
            pass
        try:
            with open("/proc/meminfo") as f:
                mem = {}
                for line in f:
                    parts = line.split()
                    if parts[0] in ("MemTotal:", "MemAvailable:"):
                        mem[parts[0]] = int(parts[1]) * 1024
            series.append(("art_node_mem_total_bytes",
                           mem.get("MemTotal:", 0), "host memory"))
            series.append(("art_node_mem_available_bytes",
                           mem.get("MemAvailable:", 0),
                           "host memory available"))
        except OSError:  # pragma: no cover — non-Linux
            pass
        for key, value in self._available.items():
            series.append(("art_node_resource_available",
                           value, "available resource", {"resource": key}))
        # Transfer-plane counters (windowed/striped pull scheduler +
        # holder-side chunk cache) as gauges for the head aggregation.
        for key, value in self.transfer_stats.items():
            series.append((f"art_node_transfer_{key}", value,
                           "object transfer-plane counter"))
        series.append(("art_node_transfer_chunk_cache_bytes",
                       self._chunk_cache_bytes,
                       "holder-side transfer chunk cache bytes"))
        series.append(("art_node_object_pull_relayed_fraction",
                       self._pull_relayed_fraction(),
                       "fraction of pulled bytes relayed through the "
                       "daemon RPC path instead of holder-direct bulk"))
        return [
            {"name": name, "type": "gauge", "value": float(value),
             "description": desc,
             "tags": (extra[0] if extra else {})}
            for name, value, desc, *extra in series
        ]

    async def _heartbeat_loop(self):
        """Liveness heartbeat + versioned resource sync (ref:
        src/ray/ray_syncer/ray_syncer.h:90 — versioned per-node state
        gossip with "don't resend what the peer knows" semantics).

        The resource view rides the heartbeat ONLY when it changed
        since the version the GCS last acked: an idle cluster's beats
        carry just the node id, so steady-state sync bytes are O(1) per
        node instead of O(resource-dict).  A change wakes the loop
        early (sub-period propagation — fresher than the fixed beat the
        full-view design had), and the GCS can command a resync after
        losing state.  Version bumps come from snapshot comparison, not
        from instrumenting every mutation site, so a missed wakeup can
        delay a delta by at most one period, never lose it."""
        gcs = self._clients.get(self._gcs_address)
        cfg = global_config()
        period = cfg.heartbeat_period_s
        if cfg.heartbeat_jitter and period > 0:
            # Phase-stagger by a hash of the node id: N daemons booted
            # together spread their beats across the period instead of
            # slamming the GCS io loop in lockstep every period.
            phase = (int(self.node_id.hex()[:8], 16) % 997) / 997.0
            await asyncio.sleep(phase * period)
        last_snap = None
        version = 0
        acked = -1
        last_gcs_ok = time.monotonic()
        consecutive_failures = 0
        while not self._stopping:
            snap = (tuple(sorted(self._available.items())),
                    self._disk_full, self._draining)
            if snap != last_snap:
                last_snap = snap
                version += 1
            payload: dict = {"node_id": self.node_id}
            if version > acked:
                payload["view"] = {
                    "available_resources": dict(self._available),
                    "disk_full": self._disk_full,
                    "draining": self._draining,
                    "drain_reason": self._drain_reason,
                    "drain_deadline": self._drain_deadline_ts,
                    "version": version,
                }
            try:
                reply = await gcs.call_async("Heartbeat", payload,
                                             timeout=10)
                if reply.get("unknown_node"):
                    await self._register()
                    acked = -1
                else:
                    if "synced" in reply:
                        acked = max(acked, reply["synced"])
                    if "resync" in reply.get("commands", ()):
                        acked = -1
                self.sync_stats["beats"] += 1
                if "view" in payload:
                    self.sync_stats["views_sent"] += 1
                last_gcs_ok = time.monotonic()
                consecutive_failures = 0
            except Exception as e:  # noqa: BLE001 — head may be restarting
                logger.debug("heartbeat failed: %s", e)
                # A flapping link must be VISIBLE (counter surfaces as
                # art_node_heartbeat_failures_total) and must not
                # busy-spin: consecutive failures back the loop off
                # exponentially, capped well under the death timeout so
                # one recovered beat still lands in time.
                self.sync_stats["failures"] += 1
                consecutive_failures += 1
                # Fail-stop on a permanently-gone head: GCS restarts
                # (FT) come back within seconds; a daemon orphaned by a
                # dead cluster must not linger burning CPU forever.
                dead_after = global_config().gcs_dead_exit_s
                if dead_after > 0 and \
                        time.monotonic() - last_gcs_ok > dead_after:
                    logger.error(
                        "GCS unreachable for %.0fs; node daemon "
                        "exiting", time.monotonic() - last_gcs_ok)
                    os._exit(1)
            self._reap_expired_pins()
            wait = period
            if consecutive_failures > 1:
                wait = max(period, min(
                    period * (2 ** (consecutive_failures - 1)),
                    global_config().heartbeat_backoff_cap_s))
            self._sync_wakeup.clear()
            try:
                await asyncio.wait_for(self._sync_wakeup.wait(), wait)
            except asyncio.TimeoutError:
                pass

    def stop(self):
        self._stopping = True
        profiler = getattr(self, "_cpu_profiler", None)
        if profiler is not None:
            self._cpu_profiler = None
            profiler.stop(final_publish=False)
        for t in self._tasks:
            t.cancel()
        # Destroy the store first: everything after can take seconds and
        # the parent's kill-grace window is short — tmpfs cleanup must
        # never lose the race.
        self.store.destroy()
        bulk = getattr(self, "_bulk", None)
        if bulk is not None:
            bulk.stop()
        self._server.stop()
        for handle in list(self._workers.values()):
            if handle.proc.poll() is None:
                handle.proc.terminate()
        deadline = time.monotonic() + 3
        for handle in list(self._workers.values()):
            remaining = max(0.05, deadline - time.monotonic())
            try:
                handle.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                handle.proc.kill()
        for proc in self._retired_procs:
            if proc.poll() is None:
                proc.kill()
        agent = getattr(self, "_agent_proc", None)
        if agent is not None and agent.poll() is None:
            agent.terminate()
        cgroups = getattr(self, "_cgroups", None)
        if cgroups is not None:
            cgroups.cleanup()
        self._clients.close_all()

    async def _shutdown_rpc(self, _payload):
        asyncio.get_running_loop().call_later(0.05, self.stop)
        return True

    # ------------------------------------------------------------ workers

    def _spawn_worker(self, actor_spec: ActorSpec | None = None,
                      runtime_env: dict | None = None) -> WorkerHandle:
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        if actor_spec is not None and runtime_env is None:
            runtime_env = actor_spec.runtime_env
        worker_id = WorkerID.from_random()
        # Workers inherit the daemon's environment as it is: no chip or
        # card mask (the JAX package gives its workers none either, and
        # the port's daemons stash no accelerator trigger to restore).
        env = dict(os.environ)
        cwd = None
        if runtime_env:
            # packages were prefetched by _ensure_runtime_env (async);
            # resolve() is pure path logic, safe on the event loop
            overlay, cwd = renv.resolve(runtime_env, self._session_dir)
            env.update(overlay)
            # A staged cwd loses the implicit cwd-based import of a
            # checkout-run framework — pin the package root explicitly.
            renv.ensure_framework_on_pythonpath(env)
        env["ART_NODE_ADDRESS"] = self.address
        env["ART_GCS_ADDRESS"] = self._gcs_address
        # Worker stdout is a log file (block-buffered by default): run
        # unbuffered so user print()s stream to the driver promptly.
        env["PYTHONUNBUFFERED"] = "1"
        env["ART_STORE_DIR"] = self.store.directory
        env["ART_WORKER_ID"] = worker_id.hex()
        env["ART_NODE_ID"] = self.node_id.hex()
        log_path = os.path.join(self._session_dir, "logs",
                                f"worker-{worker_id.hex()[:8]}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        log_file = open(log_path, "ab")
        # A pip env's workers run on its venv interpreter (built by
        # _ensure_runtime_env before the spawn reaches here).
        python = renv.venv_python(runtime_env, self._session_dir) \
            or sys.executable
        proc = subprocess.Popen(
            [python, "-m", "ant_ray_tpu_torch._private.worker_main"],
            env=env, cwd=cwd, stdout=log_file, stderr=subprocess.STDOUT,
            start_new_session=True)
        log_file.close()
        handle = WorkerHandle(worker_id, proc, actor_spec=actor_spec,
                              env_key=renv.env_key(runtime_env))
        if self._cgroups is not None:
            self._cgroups.add_worker_process(proc.pid)
        self._workers[worker_id] = handle
        return handle

    async def _register_worker(self, payload):
        worker_id = payload["worker_id"]
        handle = self._workers.get(worker_id)
        if handle is None:
            return {"error": "unknown worker"}
        handle.address = payload["address"]
        was_actor = handle.actor_spec is not None
        if was_actor:
            client = self._clients.get(handle.address)
            _spawn(
                client.call_async("InstantiateActor", handle.actor_spec,
                                  timeout=-1))
            handle.state = ACTOR
        else:
            handle.state = IDLE
            self._lease_event.set()
        handle.registered.set()
        return {"ok": True}

    async def _monitor_workers_loop(self):
        gcs = self._clients.get(self._gcs_address)
        last_orphan_sweep = 0.0
        while not self._stopping:
            await asyncio.sleep(0.1)
            if self._retired_procs:
                self._retired_procs = [p for p in self._retired_procs
                                       if p.poll() is None]
            now = time.monotonic()
            self._supervise_agent()
            if self._subreaper_enabled and now - last_orphan_sweep > 2.0:
                last_orphan_sweep = now
                self._reap_orphans()
            self._sweep_lease_owners(now)
            for worker_id, handle in list(self._workers.items()):
                if handle.proc.poll() is None:
                    continue
                del self._workers[worker_id]
                # A dead worker may itself be a lessee (nested task
                # submission): reclaim whatever it still leased.
                self._reclaim_leases_of(handle.address)
                if handle.state == LEASED and not handle.blocked:
                    if handle.lease_pg is not None:
                        self._bundle_release(handle.lease_pg,
                                             handle.lease_resources)
                    else:
                        self._release(handle.lease_resources)
                if handle.state == ACTOR and handle.actor_spec is not None:
                    if not handle.blocked:  # blocked already released
                        self._release_actor_resources(handle.actor_spec)
                    # Death reports must survive a GCS restart window —
                    # fire-and-forget here loses the actor forever
                    # (restored as ALIVE on resync with no one to
                    # correct it), so retry in the background.
                    _spawn(self._report_worker_died(
                        gcs, worker_id, handle))
                self._lease_event.set()

    def _reap_orphans(self) -> None:
        """Kill + reap grandchildren re-parented to this daemon by the
        subreaper (a dead worker's user subprocesses).  Direct children
        the daemon spawned itself (workers, runtime-env builds) share
        its session or are registered — only processes from a *foreign*
        session that aren't known workers are orphans (ref:
        src/ray/util/subreaper.h kill-unknown-children policy)."""
        known = {h.proc.pid for h in self._workers.values()}
        known |= {p.pid for p in self._retired_procs}
        agent = getattr(self, "_agent_proc", None)
        if agent is not None:
            # The node agent is a daemon child in its own session — the
            # foreign-session heuristic would reap it every sweep.
            known.add(agent.pid)
        my_pid = os.getpid()
        try:
            my_sid = os.getsid(0)
        except OSError:
            return
        try:
            candidates = [int(n) for n in os.listdir("/proc")
                          if n.isdigit()]
        except OSError:
            return
        for pid in candidates:
            # NEVER waitpid(-1): reaping a known worker here would
            # steal its exit status from Popen.poll() and turn every
            # death reason into "exited with code 0".
            if pid in known or pid == my_pid:
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                state, ppid = fields[0], int(fields[1])
                if ppid != my_pid:
                    continue
                # Session check FIRST, zombies included: a transient
                # subprocess.run child of a daemon executor thread (a
                # runtime-env build) shares our session — waitpid'ing
                # its zombie here would steal the exit status its
                # spawner is about to collect (ECHILD -> returncode 0,
                # a failed build reported as success).
                if os.getsid(pid) == my_sid:
                    continue
                if state == "Z":               # orphan already exited
                    os.waitpid(pid, os.WNOHANG)
                    continue
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, os.WNOHANG)
                logger.info("reaped orphaned process %d (parent worker "
                            "died)", pid)
            except (OSError, ValueError, IndexError):
                continue

    async def _report_worker_died(self, gcs, worker_id, handle):
        payload = {
            "node_id": self.node_id,
            "worker_id": worker_id,
            "actor_id": handle.actor_spec.actor_id,
            "reason": f"worker exited with code "
                      f"{handle.proc.returncode}",
        }
        for attempt in range(30):  # ~60s: outlasts a head restart
            try:
                await gcs.call_async("WorkerDied", payload, timeout=10)
                return
            except Exception:  # noqa: BLE001 — head may be restarting
                await asyncio.sleep(min(0.2 * (attempt + 1), 2.0))
        logger.warning("giving up reporting death of worker %s",
                       worker_id)

    # ------------------------------------------------- memory monitor
    # (ref: src/ray/common/memory_monitor.h — cgroup/proc-based node OOM
    #  detection; src/ray/raylet/worker_killing_policy.h — retriable
    #  tasks die before actors, largest first, so the node survives
    #  memory pressure instead of being OOM-killed wholesale)

    @staticmethod
    def _read_memory_used_fraction(meminfo_path: str) -> float | None:
        try:
            fields = {}
            with open(meminfo_path) as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    fields[key.strip()] = int(rest.strip().split()[0])
            total = fields.get("MemTotal", 0)
            available = fields.get("MemAvailable")
            if total <= 0 or available is None:
                # No MemAvailable (old kernel / minimal proc fake):
                # better no monitoring than reading "100% used" and
                # killing healthy workers every tick.
                return None
            return 1.0 - available / total
        except (OSError, ValueError, IndexError):
            return None

    def _worker_rss_kb(self, handle: WorkerHandle) -> int:
        try:
            with open(f"/proc/{handle.proc.pid}/statm") as f:
                return int(f.read().split()[1]) * 4  # pages → ~KiB
        except (OSError, ValueError, IndexError):
            return 0

    def _pick_oom_victim(self) -> WorkerHandle | None:
        """Retriable first (leased task workers — their tasks retry),
        then actors (they may restart); idle/starting workers are free
        memory already being reclaimed, never victims."""
        candidates = [h for h in self._workers.values()
                      if h.state in (LEASED, ACTOR)
                      and h.proc.poll() is None]  # corpses free nothing
        if not candidates:
            return None
        return max(candidates,
                   key=lambda h: (h.state == LEASED,
                                  self._worker_rss_kb(h)))

    # ---------------------------------------------- filesystem monitor
    # (ref: src/ray/common/file_system_monitor.h — a node whose local
    #  disk crosses the capacity threshold stops accepting new leases,
    #  redirecting work to nodes that can still spill/log)

    def _read_disk_used_fraction(self) -> float | None:
        import shutil  # noqa: PLC0415

        try:
            usage = shutil.disk_usage(self._session_dir or "/tmp")
            return usage.used / usage.total if usage.total else None
        except OSError:
            return None

    async def _fs_monitor_loop(self):
        cfg = global_config()
        while not self._stopping:
            used = self._read_disk_used_fraction()
            full = (used is not None
                    and used >= cfg.local_fs_capacity_threshold)
            if full and not self._disk_full:
                logger.warning(
                    "local disk %.1f%% full (>= %.1f%%): node stops "
                    "accepting new leases until space frees",
                    100 * used, 100 * cfg.local_fs_capacity_threshold)
            if full != self._disk_full:
                self._disk_full = full
                self._sync_wakeup.set()
            await asyncio.sleep(cfg.fs_monitor_interval_s)

    async def _memory_monitor_loop(self):
        cfg = global_config()
        while not self._stopping:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            used = self._read_memory_used_fraction(cfg.meminfo_path)
            if used is None or used < cfg.memory_usage_threshold:
                continue
            victim = self._pick_oom_victim()
            if victim is None:
                continue
            logger.warning(
                "memory pressure (%.1f%% used >= %.1f%%): killing "
                "worker %s (%s, rss=%dKiB) to relieve it",
                100 * used, 100 * cfg.memory_usage_threshold,
                victim.worker_id.hex()[:8], victim.state,
                self._worker_rss_kb(victim))
            self._terminate_worker(victim)
            # Death propagation (task retry / actor restart) runs via
            # the normal worker monitor; pause a beat so the kill lands
            # before the next pressure reading.
            await asyncio.sleep(cfg.memory_monitor_interval_s)

    def _terminate_worker(self, handle: WorkerHandle):
        if handle.proc.poll() is None:
            handle.proc.terminate()
            try:
                handle.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                handle.proc.kill()

    # ------------------------------------------------------------ leasing

    def _can_allocate(self, demand: dict[str, float]) -> bool:
        return all(self._available.get(k, 0.0) >= v for k, v in demand.items())

    def _feasible(self, demand: dict[str, float]) -> bool:
        return all(self._total.get(k, 0.0) >= v for k, v in demand.items())

    def _allocate(self, demand: dict[str, float]):
        for k, v in demand.items():
            self._available[k] = self._available.get(k, 0.0) - v
        self._sync_wakeup.set()

    def _release(self, demand: dict[str, float]):
        for k, v in demand.items():
            self._available[k] = self._available.get(k, 0.0) + v
        self._lease_event.set()
        self._sync_wakeup.set()

    async def _job_allowed_here(self, job_id) -> bool:
        """Virtual-cluster membership of this node for a job, cached
        briefly (VC edits are rare; a 5s-stale view only delays
        re-fencing, never correctness of results)."""
        now = time.monotonic()
        cached = self._vc_cache.get(job_id)
        if cached is not None and cached[1] > now:
            return cached[0]
        gcs = self._clients.get(self._gcs_address)
        try:
            reply = await gcs.call_async(
                "GetJobVirtualCluster", {"job_id": job_id}, timeout=10)
            allowed_hex = reply.get("allowed_node_ids")
            allowed = (allowed_hex is None
                       or self.node_id.hex() in allowed_hex)
        except Exception:  # noqa: BLE001 — fail open on GCS hiccups
            allowed = True
        if len(self._vc_cache) > 256:
            self._vc_cache = {k: v for k, v in self._vc_cache.items()
                              if v[1] > now}
        self._vc_cache[job_id] = (
            allowed, now + global_config().vc_fence_ttl_s)
        return allowed

    # ---------------------------------------------------- agent manager
    # (ref: src/ray/raylet/agent_manager.h — the raylet spawns and
    #  supervises per-node agent processes; runtime-env builds run in
    #  the agent so a slow/crashing build can't take the daemon down)

    def _start_agent(self) -> None:
        if not global_config().enable_node_agent:
            return
        from ant_ray_tpu_torch._private import services  # noqa: PLC0415

        os.makedirs(os.path.join(self._session_dir, "logs"),
                    exist_ok=True)
        agent_env = services._child_env()
        # The agent tags its published device gauges with the node id
        # (per-node series identity + death-time expiry in the GCS).
        agent_env["ART_NODE_ID"] = self.node_id.hex()
        self._agent_proc = subprocess.Popen(
            [sys.executable, "-m", "ant_ray_tpu_torch._private.node_agent",
             "--session-dir", self._session_dir,
             "--gcs-address", self._gcs_address,
             "--monitor-pid", str(os.getpid())],
            stdout=subprocess.PIPE,
            stderr=open(os.path.join(self._session_dir, "logs",
                                     "agent.err"), "ab"),
            env=agent_env, start_new_session=True)
        self._agent_address = None

        def _wait_ready(proc=self._agent_proc):
            # Off-thread READY wait: daemon boot never blocks on the
            # agent; builds fall back in-process until it reports in.
            try:
                for line in proc.stdout:
                    text = line.decode(errors="replace").strip()
                    if text.startswith("AGENT_READY"):
                        if self._agent_proc is proc:
                            self._agent_address = text.split(" ", 1)[1]
                        return
            except Exception:  # noqa: BLE001
                pass

        threading.Thread(target=_wait_ready, daemon=True).start()

    def _supervise_agent(self) -> None:
        """Restart a dead agent (called from the worker-monitor loop)
        with a simple backoff."""
        proc = getattr(self, "_agent_proc", None)
        if proc is None or proc.poll() is None:
            return
        now = time.monotonic()
        if now < getattr(self, "_agent_backoff_until", 0.0):
            return
        self._agent_backoff_until = now + min(
            2.0 * (getattr(self, "_agent_restarts", 0) + 1), 30.0)
        self._agent_restarts = getattr(self, "_agent_restarts", 0) + 1
        # Clear the dead address NOW — during the backoff window every
        # build would otherwise dial it first and pay a failed connect.
        self._agent_address = None
        logger.warning("node agent died (exit %s); restarting",
                       proc.returncode)
        self._start_agent()

    async def _ensure_runtime_env(self, wire: dict | None):
        """Prefetch + extract a runtime env's packages (working_dir +
        py_modules) and build its pip venv, so the (sync) worker spawn
        only touches local paths.  Delegated to the node agent when one
        is serving (build isolation, ref: runtime_env_agent.py:167);
        falls back in-process while the agent is down/booting."""
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        if not wire or renv.is_ready(wire, self._session_dir):
            return  # fully materialized: no RPC, no executor hop
        agent_addr = getattr(self, "_agent_address", None)
        if agent_addr:
            try:
                reply = await self._clients.get(agent_addr).call_async(
                    "BuildRuntimeEnv", {"wire": wire}, timeout=1800)
                if reply.get("ok"):
                    return
                raise RuntimeError(reply.get("error", "agent build failed"))
            except RuntimeError:
                raise
            except Exception as e:  # noqa: BLE001 — agent died mid-build
                logger.warning("agent env build unavailable (%s); "
                               "building in-process", e)
        gcs = self._clients.get(self._gcs_address)

        async def kv_get(key):
            return await gcs.call_async("KVGet", {"key": key}, timeout=60)

        await renv.materialize(wire, self._session_dir, kv_get)

    def _idle_worker(self, env_key: str = "") -> WorkerHandle | None:
        for handle in self._workers.values():
            if (handle.state == IDLE and handle.address
                    and handle.env_key == env_key):
                # Liveness check at grant: a worker that died while
                # leased gets ReturnWorker'd back to IDLE by its driver
                # before the reaper runs — handing out the corpse makes
                # every fast retry burn an attempt on a dead port.
                if handle.proc.poll() is not None:
                    continue  # reaper will collect it
                return handle
        return None

    def _retire_idle_mismatch(self, env_key: str) -> bool:
        """Kill one idle worker of a *different* runtime env so a full
        pool can still serve a new env (ref: WorkerPool eviction of
        idle workers for mismatched runtime envs).  Non-blocking: the
        monitor loop reaps the terminated process."""
        for worker_id, handle in list(self._workers.items()):
            if (handle.state == IDLE and handle.env_key != env_key
                    and handle.actor_spec is None):
                del self._workers[worker_id]
                if handle.proc.poll() is None:
                    handle.proc.terminate()
                self._retired_procs.append(handle.proc)
                return True
        return False

    def _pool_size(self) -> int:
        """Workers counted against the pool cap: task workers that are
        actually occupying a cpu.  Blocked workers (parked in get()) and
        dedicated actor workers don't count, so nested task chains can
        always make progress (ref: worker_pool starts workers beyond
        num_cpus when existing ones are blocked)."""
        return sum(1 for h in self._workers.values()
                   if h.actor_spec is None and not h.blocked)

    async def _lease_worker(self, payload):
        """Grant a worker lease or reply with a spillback target
        (ref: NodeManager::HandleRequestWorkerLease, node_manager.cc:1794).

        Traced leases (payload carries the head task's ``trace`` wire
        context) record a ``daemon:lease`` child span with the grant
        outcome, so a slow actor call can be attributed to scheduling
        rather than execution."""
        wire = payload.get("trace")
        if wire is None:
            return await self._lease_worker_impl(payload)
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        with tracing_plane.server_span(wire, "daemon:lease",
                                       "LeaseWorker") as sp:
            sp.attrs = {"outcome": "error",
                        "resources": dict(payload.get("resources", {}))}
            reply = await self._lease_worker_impl(payload)
            sp.attrs["outcome"] = next(iter(reply))
            sp.error = "infeasible" in reply
            return reply

    async def _lease_worker_impl(self, payload):
        demand: dict[str, float] = payload.get("resources", {})
        gcs = self._clients.get(self._gcs_address)
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        pg_key = payload.get("pg")
        job_id = payload.get("job_id")
        selector = payload.get("label_selector")
        strategy = payload.get("strategy")
        # Hard node affinity: this lease must run HERE once routed —
        # every redirect path below turns into an infeasible error
        # instead of a spill that would break the pin.
        pinned_here = (pg_key is None and isinstance(strategy, dict)
                       and strategy.get("kind") == "node_affinity"
                       and not strategy.get("soft")
                       and strategy["node_id"] == self.node_id.hex())
        # Strategy routing (ref: the raylet policy set,
        # composite_scheduling_policy.h:33).  PG leases are exempt —
        # the bundle reservation already placed them.  A lease that
        # already followed a strategy redirect carries "routed" (set by
        # the client on strategy spills) and is served where it landed —
        # re-running the picker on every hop would ping-pong forever
        # (the spread cursor advances per query, so it never returns
        # the node currently asking).
        if pg_key is None and strategy is not None and \
                not payload.get("routed"):
            if strategy == "SPREAD":
                node = await gcs.call_async(
                    "SelectNode",
                    {"resources": demand, "job_id": job_id,
                     "label_selector": selector,
                     "strategy": "SPREAD"}, timeout=10)
                if node is not None and node.node_id != self.node_id:
                    return {"spill": node.address, "routed": True}
                # self is the spread pick (or nothing feasible yet):
                # serve locally below.
            elif isinstance(strategy, dict) and \
                    strategy.get("kind") == "node_affinity":
                target_hex = strategy["node_id"]
                if self.node_id.hex() != target_hex:
                    infos = await gcs.call_async("GetAllNodes", {},
                                                 timeout=10)
                    target = next(
                        (n for n in infos.values()
                         if n.node_id.hex() == target_hex and n.alive),
                        None)
                    if target is not None:
                        return {"spill": target.address, "routed": True}
                    if not strategy.get("soft"):
                        return {"infeasible": True,
                                "reason": f"node-affinity target "
                                          f"{target_hex[:12]} is not "
                                          "alive"}
                    # soft affinity on a dead node: DEFAULT placement.
        # A label-constrained lease on a non-matching node redirects
        # immediately (the GCS picks a matching node); PG leases are
        # exempt — the bundle was placed under the selector already.
        if pg_key is None and selector and not all(
                self._labels.get(k) == v for k, v in selector.items()):
            if pinned_here:
                return {"infeasible": True,
                        "reason": "node-affinity target does not match "
                                  f"label selector {selector}"}
            node = await gcs.call_async(
                "SelectNode", {"resources": demand, "job_id": job_id,
                               "exclude": self.node_id,
                               "label_selector": selector}, timeout=10)
            if node is not None and node.node_id != self.node_id:
                return {"spill": node.address}
            return {"infeasible": True,
                    "reason": f"no node matches label selector {selector}"}
        # Virtual-cluster fencing: if this node isn't in the job's
        # allowed set, redirect before doing any work here (ant-fork
        # ref: node_manager.ant.cc cancels mismatched leases).  PG
        # leases are exempt — the bundle reservation (placed under the
        # VC filter at creation time) is the authority.
        if pg_key is None and job_id is not None and \
                not await self._job_allowed_here(job_id):
            if pinned_here:
                return {"infeasible": True,
                        "reason": "node-affinity target is outside the "
                                  "job's virtual cluster"}
            node = await gcs.call_async(
                "SelectNode", {"resources": demand, "job_id": job_id,
                               "exclude": self.node_id,
                               "label_selector": selector}, timeout=10)
            if node is not None and node.node_id != self.node_id:
                return {"spill": node.address}
            return {"infeasible": True,
                    "reason": "no node in this job's virtual cluster "
                              "can satisfy the request"}

        runtime_env = payload.get("runtime_env")
        deps = payload.get("deps") or ()
        env_key = renv.env_key(runtime_env)
        if runtime_env:
            await self._ensure_runtime_env(runtime_env)
        if pg_key is not None:
            bundle = self._bundles.get(pg_key)
            if deps and bundle is not None and \
                    _bundle_fits(bundle, demand):
                # Pull-before-grant (ref: LeaseDependencyManager,
                # src/ray/raylet/lease_dependency_manager.h): the
                # bundle is reserved here with enough capacity, so the
                # lease WILL be served on this node — pull the first
                # queued task's plasma args before a worker is
                # selected.  Awaiting mid-selection would race another
                # lease onto the same idle worker; no resources are
                # held during this wait, so a dep produced by a task
                # that needs this node can still schedule here.  (A
                # bundle removed/undersized skips the prefetch — the
                # loop below replies infeasible without paying for a
                # transfer first.)
                await self._prefetch_deps(deps)
            # Lease against a committed placement-group bundle: resources
            # come out of the reservation, never the general pool.
            while True:
                bundle = self._bundles.get(pg_key)
                if bundle is not None and not _bundle_fits(bundle,
                                                           demand):
                    return {"infeasible": True,
                            "reason": f"demand {demand} exceeds bundle "
                                      f"capacity {bundle['resources']}"}
                if self._bundle_can_allocate(pg_key, demand):
                    worker = self._idle_worker(env_key)
                    pool = self._pool_size() + self._starting_workers
                    if worker is None and pool >= self._max_workers + 4:
                        self._retire_idle_mismatch(env_key)
                    if worker is None and pool < self._max_workers + 4:
                        self._starting_workers += 1
                        try:
                            handle = self._spawn_worker(
                                runtime_env=runtime_env)
                            await handle.registered.wait()
                        finally:
                            self._starting_workers -= 1
                        worker = handle if handle.state == IDLE else None
                    if worker is not None:
                        self._bundle_allocate(pg_key, demand)
                        worker.state = LEASED
                        worker.lease_resources = dict(demand)
                        worker.lease_pg = pg_key
                        worker.lease_owner = payload.get("owner") or ""
                        worker.job_id = job_id
                        return {"granted": worker.address,
                                "worker_id": worker.worker_id}
                elif pg_key not in self._bundles:
                    return {"infeasible": True,
                            "reason": "bundle not reserved on this node"}
                self._lease_event.clear()
                try:
                    await asyncio.wait_for(self._lease_event.wait(),
                                           timeout=0.2)
                except asyncio.TimeoutError:
                    pass

        if self._disk_full or self._draining:
            what = ("draining (announced departure)" if self._draining
                    else "out of disk")
            if pinned_here:
                return {"infeasible": True,
                        "reason": f"node-affinity target is {what}"}
            # Redirect rather than accept work this node can't keep:
            # out-of-disk nodes lack spill/log space (ref:
            # file_system_monitor.h), draining nodes are about to die
            # (a lease granted now would be killed mid-task).
            node = await gcs.call_async(
                "SelectNode", {"resources": demand, "job_id": job_id,
                               "exclude": self.node_id,
                               "label_selector": selector}, timeout=10)
            if node is not None and node.node_id != self.node_id:
                return {"spill": node.address}
            return {"infeasible": True,
                    "reason": f"node {what} and no alternative "
                              "node can satisfy the request"}

        if not self._feasible(demand):
            if pinned_here:
                return {"infeasible": True,
                        "reason": f"node-affinity target can never "
                                  f"satisfy {demand}"}
            node = await gcs.call_async(
                "SelectNode", {"resources": demand, "job_id": job_id,
                               "exclude": self.node_id,
                               "label_selector": selector},
                timeout=10)
            if node is not None:
                return {"spill": node.address}
            return {"infeasible": True}

        if deps:
            # Pull-before-grant for the normal path — AFTER the
            # disk-full and feasibility redirects: a node about to
            # spill the lease elsewhere must not absorb the args'
            # write pressure first.
            await self._prefetch_deps(deps)
        start = time.monotonic()
        spill_deadline = start + global_config().spillback_timeout_s
        while True:
            if self._can_allocate(demand):
                worker = self._idle_worker(env_key)
                pool = self._pool_size() + self._starting_workers
                if worker is None and pool >= self._max_workers:
                    self._retire_idle_mismatch(env_key)
                if worker is None and pool < self._max_workers:
                    self._starting_workers += 1
                    try:
                        handle = self._spawn_worker(
                            runtime_env=runtime_env)
                        await handle.registered.wait()
                    finally:
                        self._starting_workers -= 1
                    worker = handle if handle.state == IDLE else None
                if worker is not None:
                    self._allocate(demand)
                    worker.state = LEASED
                    worker.lease_resources = dict(demand)
                    worker.lease_owner = payload.get("owner") or ""
                    worker.job_id = job_id
                    reply = {"granted": worker.address,
                             "worker_id": worker.worker_id}
                    extra = self._grant_extras(payload, demand, env_key,
                                               job_id)
                    if extra:
                        reply["extra"] = extra
                    return reply
            elif not pinned_here and time.monotonic() > spill_deadline:
                node = await gcs.call_async(
                    "SelectNode",
                    {"resources": demand, "job_id": job_id,
                     "exclude": self.node_id,
                     "label_selector": selector,
                     # A saturated SPREAD lease keeps spreading; routing
                     # it with the default packer would concentrate it.
                     "strategy": ("SPREAD" if strategy == "SPREAD"
                                  else None)},
                    timeout=10)
                if node is not None and node.node_id != self.node_id:
                    return {"spill": node.address}
                spill_deadline = time.monotonic() + \
                    global_config().spillback_timeout_s
            self._lease_event.clear()
            try:
                await asyncio.wait_for(self._lease_event.wait(), timeout=0.2)
            except asyncio.TimeoutError:
                pass

    def _grant_extras(self, payload, demand, env_key: str,
                      job_id) -> list[dict]:
        """Batched lease (payload ``count``): after the primary grant,
        hand out up to count-1 MORE leases from capacity that is free
        RIGHT NOW (already-idle workers; never spawns, never waits) so
        a burst of N queued tasks costs one daemon round trip instead
        of N.  Grants the client's queue has drained past come straight
        back via ReturnWorker (core._acquire_worker), so over-granting
        idle capacity is cheap; under-granting just falls back to the
        classic lease-per-round-trip cadence for the remainder."""
        extras: list[dict] = []
        want = int(payload.get("count", 1)) - 1
        while len(extras) < want and self._can_allocate(demand):
            worker = self._idle_worker(env_key)
            if worker is None:
                break
            self._allocate(demand)
            worker.state = LEASED
            worker.lease_resources = dict(demand)
            worker.lease_owner = payload.get("owner") or ""
            worker.job_id = job_id
            extras.append({"granted": worker.address,
                           "worker_id": worker.worker_id})
        return extras

    async def _return_worker(self, payload):
        handle = self._workers.get(payload["worker_id"])
        if handle is None:
            return False
        if handle.state == LEASED:
            if not handle.blocked:
                if handle.lease_pg is not None:
                    self._bundle_release(handle.lease_pg,
                                         handle.lease_resources)
                else:
                    self._release(handle.lease_resources)
            handle.blocked = False
            handle.lease_resources = {}
            handle.lease_pg = None
            handle.lease_owner = ""
            handle.state = IDLE
            self._lease_event.set()
        return True

    def _sweep_lease_owners(self, now: float) -> None:
        """Periodic lessee liveness check for owners NOT on this node
        (drivers, remote workers): a dead owner's lease can't be
        reclaimed by the local worker-death path above.  Interval and
        strike budget come from config
        (lease_owner_sweep_interval_s / lease_owner_ping_strikes)."""
        cfg = global_config()
        if now - getattr(self, "_last_owner_sweep", 0.0) < \
                cfg.lease_owner_sweep_interval_s or \
                getattr(self, "_owner_sweep_running", False):
            return
        self._last_owner_sweep = now
        local = {h.address for h in self._workers.values() if h.address}
        owners = {h.lease_owner for h in self._workers.values()
                  if h.state == LEASED and h.lease_owner
                  and h.lease_owner not in local}
        if not owners:
            return
        strikes_needed = max(1, cfg.lease_owner_ping_strikes)

        fails: dict = getattr(self, "_owner_ping_fails", None)
        if fails is None:
            fails = self._owner_ping_fails = {}
        for stale in [a for a in fails if a not in owners]:
            del fails[stale]   # else a later re-lease inherits old strikes

        async def _sweep():
            self._owner_sweep_running = True
            alive_hosts = None      # fetched at most once per sweep
            try:
                for addr in owners:
                    try:
                        await self._clients.get(addr).call_async(
                            "Ping", {}, timeout=5)
                        fails.pop(addr, None)
                    except (RpcConnectionError, RpcTimeoutError):
                        # Both refusals and black holes (established
                        # connection, no reply) count — but a LOADED
                        # owner on a saturated host can miss pings for
                        # many seconds, and a false reclaim terminates
                        # its busy workers; demand N consecutive
                        # strikes before even considering a reclaim.
                        fails[addr] = fails.get(addr, 0) + 1
                        if fails[addr] < strikes_needed:
                            continue
                        if fails[addr] < strikes_needed * 3:
                            if alive_hosts is None:
                                alive_hosts = \
                                    await self._gcs_alive_hosts()
                            if addr.rsplit(":", 1)[0] in alive_hosts:
                                # The GCS still hears heartbeats from
                                # the owner's node — likely a partition
                                # (or a stalled io loop) between THIS
                                # daemon and the owner, not a death.
                                # Defer, but only up to 3x the strike
                                # budget: node liveness says nothing
                                # about the owner PROCESS, and a dead
                                # driver on a live node must not pin
                                # leases forever.
                                logger.warning(
                                    "lease owner %s unresponsive for "
                                    "%d pings but its node is alive "
                                    "per GCS; deferring reclaim",
                                    addr, fails[addr])
                                continue
                        fails.pop(addr, None)
                        self._reclaim_leases_of(addr)
                    except Exception:  # noqa: BLE001 — reachable but
                        fails.pop(addr, None)  # erroring owner is alive
            finally:
                self._owner_sweep_running = False

        _spawn(_sweep())

    async def _gcs_alive_hosts(self) -> set:
        """Host IPs of nodes the GCS currently believes alive — the
        corroboration set for suspected-dead lease owners (an owner
        process lives on some node, and that node's daemon heartbeats
        the GCS independently of our ping path).  One RPC per sweep:
        during a real partition EVERY remote owner fails pings at
        once, and per-owner refetches would serialize 5s-timeout calls
        against an already-struggling GCS.  Empty set when the GCS
        can't confirm — then we lean toward reclaiming (a dead owner's
        leases must not pin resources forever; the GCS-down case
        fail-stops this daemon anyway via gcs_dead_exit_s)."""
        try:
            gcs = self._clients.get(self._gcs_address)
            infos = await gcs.call_async("GetAllNodes", {}, timeout=5)
        except Exception:  # noqa: BLE001 — GCS unreachable: no veto
            return set()
        return {getattr(info, "address", "").rsplit(":", 1)[0]
                for info in (infos or {}).values()
                if getattr(info, "alive", False)}

    def _reclaim_leases_of(self, owner_address: str) -> None:
        """Reclaim leases whose lessee died (ref: the raylet cancels
        leases on owner death — a dead owner can never send
        ReturnWorker, so its leases would pin resources forever; this
        is exactly the data-ingest leak where a killed train worker's
        read-task lease pool held CPUs for the rest of the session)."""
        if not owner_address:
            return
        for h in list(self._workers.values()):
            if h.state != LEASED or h.lease_owner != owner_address:
                continue
            logger.info("reclaiming lease of worker %s: owner %s died",
                        h.worker_id.hex()[:8], owner_address)
            if not h.blocked:
                if h.lease_pg is not None:
                    self._bundle_release(h.lease_pg, h.lease_resources)
                else:
                    self._release(h.lease_resources)
            h.blocked = False
            h.lease_resources = {}
            h.lease_pg = None
            h.lease_owner = ""
            # The worker may still be executing (or wedged on) the dead
            # owner's task — terminate rather than re-lease a busy
            # process (the monitor loop reaps the handle; the pool
            # respawns on demand).
            self._terminate_worker(h)
        self._lease_event.set()

    async def _worker_blocked(self, payload):
        """Worker blocked in get(): release its cpu so nested tasks can run
        (ref: raylet releases resources for blocked workers).  Applies to
        ACTOR workers too — a worker-group of actors that all block in
        get() must not starve the tasks they are waiting on (the
        data-ingest deadlock: train workers hold every CPU while the
        dataset's read tasks wait for one)."""
        handle = self._workers.get(payload["worker_id"])
        if handle is None or handle.blocked:
            return True
        if handle.state == LEASED:
            handle.blocked = True
            if handle.lease_pg is not None:
                self._bundle_release(handle.lease_pg, handle.lease_resources)
            else:
                self._release(handle.lease_resources)
        elif handle.state == ACTOR and handle.actor_spec is not None:
            handle.blocked = True
            self._release_actor_resources(handle.actor_spec)
        return True

    async def _worker_unblocked(self, payload):
        handle = self._workers.get(payload["worker_id"])
        if handle is None or not handle.blocked:
            return True
        # Re-acquire even if it drives availability negative: the worker
        # already holds the lease; balance restores at return.
        if handle.state == LEASED:
            handle.blocked = False
            if handle.lease_pg is not None:
                self._bundle_allocate(handle.lease_pg,
                                      handle.lease_resources)
            else:
                self._allocate(handle.lease_resources)
        elif handle.state == ACTOR and handle.actor_spec is not None:
            handle.blocked = False
            spec = handle.actor_spec
            if spec.placement_group_id is not None:
                self._bundle_allocate(
                    (spec.placement_group_id,
                     spec.placement_group_bundle_index), spec.resources)
            else:
                self._allocate(spec.resources)
        return True

    # ------------------------------------------------------------ bundles
    # 2-phase placement-group reservation (ref: raylet
    # placement_group_resource_manager.h prepare/commit/return)

    async def _prepare_bundle(self, payload):
        key = (payload["pg_id"], payload["index"])
        if key in self._bundles:
            return {"ok": True}  # idempotent retry
        resources = payload["resources"]
        if not self._can_allocate(resources):
            return {"ok": False, "reason": "insufficient resources"}
        self._allocate(resources)
        self._bundles[key] = {
            "resources": dict(resources),
            "available": dict(resources),
            "committed": False,
        }
        return {"ok": True}

    async def _commit_bundle(self, payload):
        key = (payload["pg_id"], payload["index"])
        bundle = self._bundles.get(key)
        if bundle is None:
            return {"ok": False}
        bundle["committed"] = True
        return {"ok": True}

    async def _return_bundle(self, payload):
        key = (payload["pg_id"], payload["index"])
        bundle = self._bundles.pop(key, None)
        if bundle is not None:
            # Release only the unused portion now; leases still running
            # against this bundle return their share to the general pool
            # when they finish (see _bundle_release) — otherwise removal
            # would oversubscribe the node while tasks still run.
            self._release(bundle["available"])
        return True

    def _bundle_can_allocate(self, key, demand) -> bool:
        bundle = self._bundles.get(key)
        return bundle is not None and bundle["committed"] and all(
            bundle["available"].get(k, 0.0) >= v for k, v in demand.items())

    def _bundle_allocate(self, key, demand):
        bundle = self._bundles.get(key)
        if bundle is None:
            # Bundle returned/removed while the holder was blocked: its
            # (released) share went back to the general pool with the
            # bundle, so re-acquire from the pool (mirror of the
            # _bundle_release fallback).
            self._allocate(demand)
            return
        for k, v in demand.items():
            bundle["available"][k] = bundle["available"].get(k, 0.0) - v

    def _bundle_release(self, key, demand):
        bundle = self._bundles.get(key)
        if bundle is None:
            # Bundle was removed while this lease was outstanding: its
            # in-use portion was withheld from the general pool at
            # ReturnBundle time, so it goes back to the pool here.
            self._release(demand)
            return
        for k, v in demand.items():
            bundle["available"][k] = bundle["available"].get(k, 0.0) + v
        self._lease_event.set()

    # ------------------------------------------------------------ actors

    async def _start_actor_worker(self, spec: ActorSpec):
        if spec.runtime_env:
            await self._ensure_runtime_env(spec.runtime_env)
        if spec.placement_group_id is not None:
            key = (spec.placement_group_id,
                   spec.placement_group_bundle_index)
            if not self._bundle_can_allocate(key, spec.resources):
                raise RuntimeError("bundle cannot host this actor")
            self._bundle_allocate(key, spec.resources)
            self._spawn_worker(actor_spec=spec)
            return True
        placement = spec.placement_resources or spec.resources
        if not self._feasible(placement):
            raise RuntimeError("insufficient node resources for actor")
        # Only the running demand is held for the actor's lifetime
        # (placement demand is a scheduling-time constraint).
        self._allocate(spec.resources)
        self._spawn_worker(actor_spec=spec)
        return True

    async def _kill_actor_worker(self, payload):
        actor_id = payload["actor_id"]
        for handle in list(self._workers.values()):
            if handle.actor_spec is not None and \
                    handle.actor_spec.actor_id == actor_id:
                # Clear the spec first so the monitor loop doesn't report
                # an (expected) death to the GCS.
                spec = handle.actor_spec
                handle.actor_spec = None
                handle.state = STARTING
                if not handle.blocked:  # blocked already released
                    self._release_actor_resources(spec)
                handle.blocked = False
                self._terminate_worker(handle)
                return True
        return False

    def _release_actor_resources(self, spec: ActorSpec):
        if spec.placement_group_id is not None:
            self._bundle_release(
                (spec.placement_group_id,
                 spec.placement_group_bundle_index), spec.resources)
        else:
            self._release(spec.resources)

    # ------------------------------------------------------------ objects

    async def _seal_object(self, payload):
        """A colocated process wrote `<store_dir>/<hex>.tmp.<nonce>`; rename
        into place and account for it."""
        object_id: ObjectID = payload["object_id"]
        final = self.store.seal_file(object_id, payload["tmp_path"])
        gcs = self._clients.get(self._gcs_address)
        await gcs.call_async(
            "ObjectLocationAdd",
            self._location_add_payload(object_id, payload), timeout=10)
        return {"path": final}

    def _location_add_payload(self, object_id: ObjectID,
                              seal_payload: dict) -> dict:
        """Directory registration for a freshly SEALED object — the
        producer's attribution (owner address, optional creation
        callsite) rides along so `art memory` can say who made it."""
        out = {"object_id": object_id, "node_id": self.node_id}
        if seal_payload.get("owner"):
            out["owner"] = seal_payload["owner"]
        if seal_payload.get("callsite"):
            out["callsite"] = seal_payload["callsite"]
        return out

    async def _create_buffer(self, payload):
        """Grant a colocated producer a write window in the arena
        (plasma create→seal protocol; ref: CreateRequestQueue)."""
        from ant_ray_tpu_torch._private.object_store import BufferExistsError  # noqa: PLC0415

        if not self.store.uses_arena:
            return {"unsupported": True}
        object_id = payload["object_id"]
        try:
            offset = self.store.create_buffer(object_id, payload["size"])
        except BufferExistsError as e:
            if e.sealed:
                return {"exists": True}
            # An unsealed grant may belong to a live producer (or to our
            # own in-flight pull) still writing through its view — only
            # reclaim it once it has gone stale (crashed producer).
            ttl = global_config().unsealed_grant_ttl_s
            if self.store.grant_age(object_id) < ttl:
                return {"busy": True}
            self.store.abort_buffer(object_id)
            try:
                offset = self.store.create_buffer(object_id,
                                                  payload["size"])
            except BufferExistsError as e2:
                return {"exists": True} if e2.sealed else {"busy": True}
        return {"path": self.store.arena_path,
                "offset": self.store.arena_file_offset(offset)}

    async def _seal_buffer(self, payload):
        object_id = payload["object_id"]
        self.store.seal_buffer(object_id)
        gcs = self._clients.get(self._gcs_address)
        await gcs.call_async(
            "ObjectLocationAdd",
            self._location_add_payload(object_id, payload), timeout=10)
        return True

    # Hard cap on any single pin lease: a misconfigured client can't
    # wedge an arena slot forever — live readers renew well inside this,
    # so only crashed readers ever hit it.
    _MAX_PIN_LEASE_S = 3600.0

    def _pin_lease_s(self, ttl: float | None) -> float:
        return min(max(ttl or 0.0, global_config().read_pin_ttl_s),
                   self._MAX_PIN_LEASE_S)

    def _locate_pinned(self, object_id: ObjectID,
                       ttl: float | None = None) -> dict | None:
        """Locate for a reader, pinning arena entries until the client's
        ReadDone — eviction reuses arena slots, so an unpinned window
        could be recycled mid-copy.  Each pin carries a lease so a
        reader that dies before ReadDone can't wedge the slot forever
        (the heartbeat loop reaps expired leases).  Zero-copy readers
        pass a longer ``ttl`` since they hold the window for the
        lifetime of the deserialized value, not just a memcpy, and
        renew it via RenewPins heartbeats."""
        located = self.store.locate(object_id)
        if located is not None and located["offset"] is not None:
            token = self._next_pin_token
            self._next_pin_token += 1
            self.store.pin(object_id, token)
            self._pin_leases.setdefault(object_id, {})[token] = (
                time.monotonic() + self._pin_lease_s(ttl))
            located["pinned"] = True
            located["pin_token"] = token
        return located

    async def _read_done(self, payload):
        object_id = payload["object_id"]
        leases = self._pin_leases.get(object_id)
        if not leases:
            return True
        token = payload.get("pin_token")
        if token is None:
            # Legacy caller without a token: drop the earliest-expiring
            # lease (best effort).
            token = min(leases, key=leases.get)
        if leases.pop(token, None) is not None:
            if not leases:
                self._pin_leases.pop(object_id, None)
            self.store.unpin(object_id, token)
        return True

    async def _renew_pins(self, payload):
        """Batch-extend live readers' pin leases (one client heartbeat
        renews every pin that client still holds).  Renewal instead of
        an unbounded TTL keeps the reap loop able to reclaim pins of
        crashed readers within ~one TTL.  Replies with the (oid, token)
        pairs that no longer exist so the client can scream — a gone
        pin under a live value means its bytes may be recycled."""
        ttl = self._pin_lease_s(payload.get("ttl"))
        expiry = time.monotonic() + ttl
        gone = []
        for oid, token in payload["pins"]:
            leases = self._pin_leases.get(oid)
            if leases is None or token not in leases:
                gone.append((oid, token))
            else:
                leases[token] = expiry
        return {"gone": gone}

    def _reap_expired_pins(self):
        now = time.monotonic()
        for object_id in list(self._pin_leases):
            leases = self._pin_leases[object_id]
            for token, expiry in list(leases.items()):
                if expiry < now:
                    del leases[token]
                    self.store.unpin(object_id, token)
                    logger.warning(
                        "read pin on %s expired without ReadDone",
                        object_id.hex()[:8])
            if not leases:
                self._pin_leases.pop(object_id, None)

    async def _locate_object(self, payload):
        located = self.store.locate(payload["object_id"])
        if located is not None:
            # Transfer-source probes learn the bulk data channel here
            # (additive key; colocated readers ignore it).
            located["bulk_port"] = self._bulk_port
        return located

    async def _contains_object(self, payload):
        return self.store.contains(payload["object_id"])

    async def _prefetch_deps(self, deps) -> None:
        """Pull a pending lease's plasma args node-local before grant
        (ref: lease_dependency_manager.h — pull-before-grant).  Bounded
        by lease_dep_prefetch_timeout_s: a missing or slow dep delays
        the grant at most that long; the executing worker's own fetch
        stays the authority either way.  Concurrent leases of one
        scheduling key all carry the head task's deps, so per-object
        pulls coalesce node-wide — N parallel leases cost ONE transfer,
        not N.  Tracked in sync_stats for tests/observability."""
        budget = global_config().lease_dep_prefetch_timeout_s
        if budget <= 0:
            return
        await asyncio.gather(
            *[self._coalesced_prefetch(oid, budget) for oid in deps])

    def _coalesced_prefetch(self, oid, budget: float):
        task = self._prefetching.get(oid)
        if task is None or task.done():
            task = asyncio.ensure_future(self._prefetch_one(oid, budget))
            self._prefetching[oid] = task
            task.add_done_callback(
                lambda _t, o=oid: (self._prefetching.pop(o, None)
                                   if self._prefetching.get(o) is _t
                                   else None))
        return asyncio.shield(task)

    async def _prefetch_one(self, oid, budget: float) -> None:
        try:
            reply = await self._ensure_local(
                {"object_id": oid, "timeout": budget, "prefetch": True,
                 # A dep with no holders yet (producer still running,
                 # or eviction raced us) stops costing grant latency
                 # quickly — the worker's own fetch is the authority.
                 # Same knob as worker-side fetches so one setting
                 # tunes the whole no-holders policy.
                 "fail_fast_after": min(
                     global_config().pull_no_holders_grace_s, budget)})
            if reply.get("ok"):
                self.sync_stats["dep_prefetches"] = (
                    self.sync_stats.get("dep_prefetches", 0) + 1)
        except Exception:  # noqa: BLE001 — prefetch is best-effort
            pass

    async def _ensure_local(self, payload):
        """Make the object local (pull from a holder if needed); reply
        path (ref: PullManager, pull_manager.h:50).  Traced pulls
        (payload ``trace``) record a ``daemon:object_pull`` child span
        with the pulled size — the wire/queue decomposition of a slow
        ``get()`` lands in the request's trace."""
        wire = payload.get("trace")
        if wire is None:
            return await self._ensure_local_impl(payload)
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        with tracing_plane.server_span(wire, "daemon:object_pull",
                                       "EnsureLocal") as sp:
            sp.attrs = {"object_id": payload["object_id"].hex()}
            reply = await self._ensure_local_impl(payload)
            sp.attrs["size"] = reply.get("size")
            sp.error = "no_holders" in reply or "timeout" in reply
            return reply

    async def _ensure_local_impl(self, payload):
        object_id: ObjectID = payload["object_id"]
        prefetch = payload.get("prefetch", False)
        deadline = time.monotonic() + payload.get("timeout", 60.0)
        # After this many seconds of continuously-empty holder lists the
        # request fails fast with {"no_holders"} so the owner can start
        # lineage reconstruction instead of burning the full timeout
        # (ref: ObjectRecoveryManager, object_recovery_manager.h:98).
        fail_fast_after = payload.get("fail_fast_after")
        pin_ttl = payload.get("pin_ttl")

        def _locate():
            # Prefetch (lease dependency pulls) wants locality only —
            # taking a read pin would wedge the slot until a ReadDone
            # nobody will ever send.
            if prefetch:
                return ({"ok": True} if self.store.contains(object_id)
                        else None)
            return self._locate_pinned(object_id, pin_ttl)

        no_holders_since: float | None = None
        located = _locate()
        if located is not None:
            return located
        gcs = self._clients.get(self._gcs_address)
        pull_failures = 0
        while time.monotonic() < deadline:
            # A colocated producer (or a concurrent EnsureLocal) may have
            # sealed the object since the last iteration.
            located = _locate()
            if located is not None:
                return located
            holders: list[NodeInfo] = await gcs.call_async(
                "ObjectLocationsGet", {"object_id": object_id}, timeout=10)
            holders = [h for h in holders if h.node_id != self.node_id]
            # Randomized holder order spreads a broadcast across every
            # node that already completed its pull, instead of every
            # puller hammering the first-listed holder.  (The stripe
            # planner re-sorts deterministically; randomization still
            # picks WHICH holder serves a small, unstriped object.)
            random.shuffle(holders)
            viable = False
            # A round with NO reachable copy feeds the fail-fast clock
            # only when every listed holder verifiably lost the object
            # (retracted) — a merely-unreachable holder (restarting RPC
            # server, short partition) must not fast-track the owner
            # into lineage reconstruction.
            holderless = not holders
            if holders:
                try:
                    await self._pull_object(object_id, holders)
                    viable = True
                    pull_failures = 0
                except _NoViableHolder as e:
                    # Stale misses were retracted inside _pull_object,
                    # so the NEXT GCS round already sees an honest
                    # list — re-locate immediately.
                    holderless = not e.any_unreachable
                except Exception as e:  # noqa: BLE001 — transient pull
                    # A viable holder existed but the transfer failed
                    # mid-flight (holder death, concurrent grant): the
                    # holder list is refreshed right away; back off only
                    # on CONSECUTIVE failures so one dead holder never
                    # costs a 50 ms sleep while live ones remain.
                    logger.debug("pull of %s failed: %s",
                                 object_id.hex()[:8], e)
                    viable = True
                    pull_failures += 1
                    if pull_failures > 1:
                        await asyncio.sleep(
                            min(0.02 * pull_failures, 0.5))
            if viable:
                no_holders_since = None
                located = _locate()
                if located is not None:
                    await gcs.call_async("ObjectLocationAdd", {
                        "object_id": object_id,
                        "node_id": self.node_id}, timeout=10)
                    return located
                continue
            # Full round with no viable holder: fail-fast bookkeeping
            # (true holderless rounds only) and the (only) inter-round
            # sleep.  A locally-spilled (or mid-produce) object never
            # feeds the clock: the holder list excludes THIS node, so
            # on a single-holder node every round is "holderless" even
            # while the payload sits in the local spill dir — and a
            # transiently-failing restore (store full of pinned
            # entries) would otherwise escalate into a terminal
            # "no holders" verdict on an object that provably exists.
            if not holderless or self.store.contains(object_id):
                no_holders_since = None
            elif fail_fast_after is not None:
                now = time.monotonic()
                if no_holders_since is None:
                    no_holders_since = now
                elif now - no_holders_since >= fail_fast_after:
                    located = _locate()
                    return located if located is not None else {
                        "no_holders": True}
            await asyncio.sleep(0.05)
        return {"timeout": True}

    async def _pull_object(self, object_id: ObjectID, holders):
        """One pull attempt: probe the listed holders (concurrently, one
        RTT), retract stale locations, then stream the object in with
        the windowed/striped chunk scheduler.  Quota accounts the whole
        object size ONCE — stripes share the object's admission, they
        are not independent transfers."""
        gcs = self._clients.get(self._gcs_address)

        async def probe(holder):
            try:
                info = await self._clients.get(holder.address).call_async(
                    "LocateObject", {"object_id": object_id}, timeout=10)
            except Exception:  # noqa: BLE001 — unreachable holder
                return holder, -1
            return holder, info

        live, size, bulk_ports = [], None, {}
        any_unreachable = False

        async def absorb(holder, info) -> None:
            nonlocal size, any_unreachable
            if info is None:
                # Stale location (holder evicted it): retract so the
                # next round sees an honest holder list.
                await gcs.oneway_async("ObjectLocationRemove", {
                    "object_id": object_id, "node_id": holder.node_id})
            elif info == -1:
                any_unreachable = True
            else:
                live.append(holder)
                size = info["size"]
                bulk_ports[holder.node_id] = info.get("bulk_port")

        # Probe SEQUENTIALLY until one holder answers (the common
        # broadcast of a small object costs ONE probe per puller, like
        # the old path — not O(holders), which would make an N-node
        # broadcast O(N^2) control RPCs cluster-wide)...
        remaining = list(holders)
        while remaining and not live:
            holder = remaining.pop(0)
            await absorb(*(await probe(holder)))
        if not live:
            raise _NoViableHolder(object_id.hex()[:12], any_unreachable)
        # ...and fan the rest out concurrently ONLY when the size makes
        # striping possible and extra holders would add NIC lanes.
        stripe_min = global_config().object_stripe_min_bytes
        if remaining and stripe_min > 0 and size >= stripe_min:
            for holder, info in await asyncio.gather(
                    *[probe(h) for h in remaining]):
                await absorb(holder, info)
        await self._acquire_pull_quota(size)
        try:
            await self._pull_body(object_id, size, live, bulk_ports)
        finally:
            await self._release_pull_quota(size)

    async def _acquire_pull_quota(self, size: int):
        """Admission control on inbound transfer bytes (ref:
        pull_manager.h:50 pull quota): a burst of pulls bigger than the
        quota queues here instead of over-committing store memory."""
        quota = global_config().pull_quota_bytes
        if quota <= 0:
            return
        async with self._pull_quota_cv:
            if self._pull_bytes_inflight > 0 and \
                    self._pull_bytes_inflight + size > quota:
                self.transfer_stats["quota_waits"] += 1
            while (self._pull_bytes_inflight > 0
                   and self._pull_bytes_inflight + size > quota):
                await self._pull_quota_cv.wait()
            self._pull_bytes_inflight += size

    async def _release_pull_quota(self, size: int):
        if global_config().pull_quota_bytes <= 0:
            return
        async with self._pull_quota_cv:
            self._pull_bytes_inflight -= size
            self._pull_quota_cv.notify_all()

    async def _pull_body(self, object_id: ObjectID, size: int, live,
                         bulk_ports):
        """Create the local grant and stream the payload in; chunks land
        position-addressed (out of order), so the write sink is a
        random-access memoryview for both backends (bulk pumps
        ``recv_into`` socket bytes straight into it)."""
        if self.store.uses_arena:
            from ant_ray_tpu_torch._private.object_store import BufferExistsError  # noqa: PLC0415

            try:
                self.store.create_buffer(object_id, size)
            except BufferExistsError as e:
                if e.sealed:
                    return  # already local — nothing to pull
                # Another coroutine's pull (or a local producer) owns the
                # grant; let the caller's retry loop re-check presence.
                raise RuntimeError(
                    "concurrent write in progress for this object") from e
            try:
                view = self.store.view_unsealed(object_id)

                def view_at(off, n):
                    return view[off:off + n]

                await self._pull_chunks(object_id, size, live,
                                        bulk_ports, view_at)
            except BaseException:
                # Includes CancelledError at shutdown: never leave a
                # wedged half-written grant (we created it above, so it
                # is ours to abort).
                self.store.abort_buffer(object_id)
                raise
            self.store.seal_buffer(object_id)
            return
        tmp = self.store.path_of(object_id) + ".pull"
        try:
            with open(tmp, "w+b") as f:
                if size > 0:
                    import mmap  # noqa: PLC0415

                    f.truncate(size)
                    m = mmap.mmap(f.fileno(), size)
                    view = memoryview(m)

                    def view_at(off, n):
                        return view[off:off + n]

                    await self._pull_chunks(object_id, size, live,
                                            bulk_ports, view_at)
                    m.flush()
                    # No explicit close: a straggler pump thread may
                    # still hold a slice; GC reclaims the mapping once
                    # the last view dies (the file itself is renamed by
                    # seal_file below, which mmaps don't mind).
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise
        self.store.seal_file(object_id, tmp)

    async def _pull_chunks(self, object_id: ObjectID, size: int, live,
                           bulk_ports, view_at):
        """Streaming chunk scheduler (ref: PushManager windowed chunking,
        push_manager.h:28, redesigned pull-side).

        * **Windowed pipelining** — each holder pump keeps up to
          ``object_pull_window`` chunk requests in flight, so
          throughput is bounded by the wire, not chunk_size/RTT.
        * **Bulk data channel** — holders that advertise a bulk port
          are drained by a blocking-socket worker thread
          (transfer.pull_chunks) that ``recv_into``-s replies straight
          into the grant view: socket → shared memory with no event
          loop or pickle on the hot path.  Holders without one (older
          peers) fall back to windowed ReadChunkRaw RPCs.
        * **Multi-holder striping** — past ``object_stripe_min_bytes``
          with >=2 live holders, the chunk range is partitioned into
          contiguous per-holder stripes pulled concurrently into the
          same grant.  Holder order is DETERMINISTIC (node-id sort) so
          every puller in a broadcast assigns the same stripe to the
          same holder — each holder's chunk cache then serves exactly
          its stripe and the read-each-chunk-once property survives.
        * **Failover without re-pull** — a dying pump returns every
          chunk it did not complete to a shared overflow queue; live
          pumps drain it, and if none remain a spare/finished holder is
          respawned.  No completed byte is ever transferred twice.
        """
        import threading  # noqa: PLC0415

        from ant_ray_tpu_torch._private import transfer  # noqa: PLC0415

        cfg = global_config()
        chunk = cfg.object_transfer_chunk_size
        window = max(1, cfg.object_pull_window)
        offsets = list(range(0, size, chunk))
        striped = (cfg.object_stripe_min_bytes > 0
                   and size >= cfg.object_stripe_min_bytes
                   and len(live) >= 2 and len(offsets) >= 2)
        if striped:
            # Deterministic stripe-to-holder assignment (see docstring).
            # Unstriped pulls keep the caller's shuffled order — the
            # shuffle is what spreads a small-object broadcast across
            # holders instead of hammering the lowest node id.
            live = sorted(live, key=lambda h: h.node_id.hex())
        k = len(live) if striped else 1
        share = (len(offsets) + k - 1) // k
        owns = [deque(offsets[i * share:(i + 1) * share])
                for i in range(k)]
        overflow: deque = deque()
        spares = deque(live[k:])
        stop = threading.Event()
        if striped:
            self.transfer_stats["stripe_pulls"] += 1

        def make_take(own: deque):
            def take():
                if stop.is_set():
                    return None
                # try/except, not check-then-pop: the overflow deque is
                # shared across pump threads and the io loop.
                try:
                    return own.popleft()
                except IndexError:
                    pass
                try:
                    return overflow.popleft()
                except IndexError:
                    return None
            return take

        async def bulk_pump(holder, own: deque, port: int):
            host = holder.address.rsplit(":", 1)[0]
            progress = [0]            # single writer: the pump thread
            fut = asyncio.get_running_loop().run_in_executor(
                None, transfer.pull_chunks, (host, port), object_id,
                size, chunk, window, make_take(own), overflow.append,
                view_at, striped, progress)
            try:
                await asyncio.shield(fut)
            except asyncio.CancelledError:
                # The worker thread cannot be cancelled; tell it to stop
                # taking chunks and reap it so no writer outlives the
                # grant this coroutine's caller is about to abort.
                stop.set()
                try:
                    await fut
                except Exception:  # noqa: BLE001 — already cancelling
                    pass
                raise
            except transfer.BulkMiss as e:
                raise _HolderMiss(str(e)) from e
            finally:
                # Tallied HERE (io loop), success AND failure paths —
                # chunks a dying holder already delivered stay written
                # (never re-pulled), so they must stay counted.  Skip
                # only if the thread still runs (double-cancel); its
                # write would race the read.
                if fut.done():
                    self.transfer_stats["pull_bytes"] += progress[0]
                    self.transfer_stats["pull_bytes_bulk"] += progress[0]

        async def rpc_pump(holder, own: deque):
            from ant_ray_tpu_torch.exceptions import ObjectLostError  # noqa: PLC0415

            remote = self._clients.get(holder.address)
            take = make_take(own)
            inflight: deque = deque()
            method = "ReadChunkRaw"
            try:
                while True:
                    while len(inflight) < window:
                        off = take()
                        if off is None:
                            break
                        n = min(chunk, size - off)
                        try:
                            fut = await remote.send_request(
                                method,
                                {"object_id": object_id, "offset": off,
                                 "length": n, "stripe": striped})
                        except BaseException:
                            # The taken offset is in neither inflight
                            # nor the queues — requeue before failing.
                            overflow.append(off)
                            raise
                        inflight.append((off, n, fut))
                    if not inflight:
                        return
                    off, n, fut = inflight.popleft()
                    try:
                        data = await asyncio.wait_for(fut, 60)
                    except ObjectLostError:
                        overflow.append(off)
                        raise _HolderMiss(
                            "holder no longer has the object") from None
                    except RpcError as e:
                        overflow.append(off)
                        if "no route" in str(e) and \
                                "ReadChunkRaw" in str(e):
                            # Pre-raw-frame peer: fall back to the
                            # legacy pickled ReadChunk for this holder.
                            # Every already-pipelined raw future fails
                            # the same way and re-enters this branch,
                            # so window > 1 drains cleanly too.
                            method = "ReadChunk"
                            continue
                        raise
                    except BaseException:
                        overflow.append(off)
                        raise
                    if data is None:
                        overflow.append(off)
                        raise _HolderMiss(
                            "holder no longer has the object")
                    if len(data) != n:
                        overflow.append(off)
                        raise RuntimeError(
                            f"short read at {off}/{size} from holder")
                    view_at(off, n)[:] = data
                    self.transfer_stats["pull_bytes"] += n
                    self.transfer_stats["pull_bytes_relayed"] += n
            except BaseException:
                # In-flight chunks go back for survivors — exactly the
                # not-yet-completed remainder, never a re-pulled byte.
                overflow.extend(o for o, _n, _f in inflight)
                raise

        async def pump(holder, own: deque):
            port = bulk_ports.get(holder.node_id)
            try:
                if port:
                    await bulk_pump(holder, own, port)
                else:
                    await rpc_pump(holder, own)
            except BaseException:
                overflow.extend(own)
                own.clear()
                raise

        tasks = {asyncio.ensure_future(pump(live[i], owns[i])): live[i]
                 for i in range(k)}
        healthy: list = []
        last_err: BaseException | None = None
        gcs = self._clients.get(self._gcs_address)
        try:
            while tasks:
                done, _ = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    holder = tasks.pop(t)
                    err = t.exception()
                    if err is None:
                        healthy.append(holder)
                        continue
                    last_err = err
                    self.transfer_stats["holder_failures"] += 1
                    if striped and overflow:
                        self.transfer_stats["stripe_failovers"] += 1
                    if isinstance(err, _HolderMiss):
                        await gcs.oneway_async("ObjectLocationRemove", {
                            "object_id": object_id,
                            "node_id": holder.node_id})
                    logger.debug("pull pump for %s on %s failed: %s",
                                 object_id.hex()[:8], holder.address,
                                 err)
                if not tasks and overflow:
                    # Every pump is gone but chunks remain: respawn on a
                    # spare holder, else one that finished its stripe
                    # cleanly (it is alive and still holds the object).
                    nxt = (spares.popleft() if spares
                           else healthy.pop() if healthy else None)
                    if nxt is None:
                        raise last_err or RuntimeError(
                            "pull failed on every holder")
                    tasks[asyncio.ensure_future(pump(nxt, deque()))] = nxt
            if overflow or any(owns):
                raise last_err or RuntimeError(
                    "pull ended with chunks missing")
        except BaseException:
            stop.set()
            for t in tasks:
                t.cancel()
            if tasks:
                # Reap pumps (including their executor threads) BEFORE
                # the caller aborts the grant — a straggler writer must
                # never touch a recycled arena range.
                try:
                    await asyncio.gather(*tasks, return_exceptions=True)
                except asyncio.CancelledError:
                    # Double cancel: a second cancellation landing while
                    # we reap the pumps must not mask the original
                    # failure re-raised below.
                    pass
            raise

    def _on_store_delete(self, object_id: ObjectID):
        """Store eviction hook: retract this node's GCS location record
        so pullers don't chase stale holders (and owners can trigger
        lineage reconstruction promptly).  May fire on any thread."""
        if self._stopping or not self.address:
            return
        try:
            self._io.loop.call_soon_threadsafe(
                self._drop_cached_chunks, object_id)
        except RuntimeError:   # loop closed: teardown eviction
            pass
        try:
            gcs = self._clients.get(self._gcs_address)
            self._io.loop.call_soon_threadsafe(
                _spawn,
                gcs.oneway_async("ObjectLocationRemove", {
                    "object_id": object_id, "node_id": self.node_id}))
        except Exception:  # noqa: BLE001 — best-effort during teardown
            pass

    async def _read_chunk(self, payload):
        """Serve one transfer chunk, memoized: during a broadcast every
        puller asks for the same chunks, so the store is read once per
        chunk and the bytes are shared across repliers (objects are
        immutable while they exist; deletion drops the cache entries)."""
        key = (payload["object_id"], payload["offset"], payload["length"])
        self._chunk_read_log.append((key[0].hex(), key[1], key[2]))
        cached = self.cache_get_chunk(key)
        if cached is not None:
            self._bump_stats(chunk_cache_hits=1)
            return cached
        data = self.store.read_chunk(*key)
        self._bump_stats(chunk_reads=1)
        self.cache_put_chunk(key, data)
        return data

    def _bump_stats(self, **deltas) -> None:
        """Transfer-counter increments under the cache lock — bulk
        handler threads bump the same dict slots concurrently, and +=
        on a dict slot is a read-modify-write."""
        with self._chunk_cache_lock:
            for key, delta in deltas.items():
                self.transfer_stats[key] += delta

    def cache_get_chunk(self, key):
        """LRU chunk-cache lookup (io loop AND bulk threads)."""
        with self._chunk_cache_lock:
            cached = self._chunk_cache.get(key)
            if cached is not None:
                self._chunk_cache.move_to_end(key)
            return cached

    def cache_put_chunk(self, key, data) -> None:
        """Memoize a served chunk under the byte cap (stable copy —
        cache entries must outlive arena slots)."""
        cap = global_config().transfer_chunk_cache_bytes
        if cap <= 0 or len(data) > cap:
            return
        data = bytes(data)
        with self._chunk_cache_lock:
            if key in self._chunk_cache:
                return
            self._chunk_cache[key] = data
            self._chunk_cache_bytes += len(data)
            while self._chunk_cache_bytes > cap:
                _old_key, old = self._chunk_cache.popitem(last=False)
                self._chunk_cache_bytes -= len(old)

    def _read_chunk_raw(self, payload):
        """Zero-copy transfer chunk serving (sync FAST route: the raw
        reply is written before any other io-loop task can run, so an
        arena view is handed straight to the transport — no bytes
        materialization, no pickle round trip).  The chunk cache key
        stays ``(object_id, offset, length)``: striped pulls use the
        same uniform chunk offsets, so stripe reads and broadcast reads
        memoize identically.  Replies ``None`` when the object is gone
        (stale holder — the puller retracts the location)."""
        key = (payload["object_id"], payload["offset"], payload["length"])
        self._chunk_read_log.append((key[0].hex(), key[1], key[2]))
        delay = global_config().testing_chunk_serve_delay_s
        cached = self.cache_get_chunk(key)
        if cached is not None:
            self._bump_stats(chunk_cache_hits=1,
                             **({"stripe_cache_hits": 1}
                                if payload.get("stripe") else {}))
            return (self._delayed_raw(cached, delay) if delay > 0
                    else RawReply(cached))
        # PINNED view, not a bare one: bulk handler threads mutate the
        # store concurrently (restore -> create -> evict), so an
        # unpinned arena window could be recycled before the transport
        # consumes it.  The pin drops via the RawReply release hook
        # right after the write.
        token = ("rawrpc", next(_raw_serve_tokens))
        data = self.store.chunk_view_pinned(*key, token)
        if data is None:
            return None
        self._bump_stats(chunk_reads=1)
        # cache_put_chunk makes its own stable copy under the cap; the
        # reply still serves the live view (zero-copy on this route).
        self.cache_put_chunk(key, data)
        oid = key[0]
        if delay > 0:
            reply = self._delayed_raw(data, delay)
            self.store.unpin(oid, token)   # _delayed_raw copied already
            return reply
        return RawReply(data,
                        release=lambda: self.store.unpin(oid, token))

    def _delayed_raw(self, data, delay: float):
        """Test-only slow serving (testing_chunk_serve_delay_s): resolve
        the reply future after a pause so tests can kill a holder
        mid-transfer deterministically.  The payload is copied — the
        synchronous-write zero-copy guarantee doesn't hold across the
        delay."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        data = bytes(data)
        loop.call_later(
            delay,
            lambda: None if fut.done() else fut.set_result(RawReply(data)))
        return fut

    def _drop_cached_chunks(self, object_id: ObjectID) -> None:
        with self._chunk_cache_lock:
            for key in [k for k in self._chunk_cache
                        if k[0] == object_id]:
                self._chunk_cache_bytes -= len(self._chunk_cache.pop(key))

    def _pull_relayed_fraction(self) -> float:
        relayed = self.transfer_stats["pull_bytes_relayed"]
        total = relayed + self.transfer_stats["pull_bytes_bulk"]
        return relayed / total if total else 0.0

    async def _get_transfer_stats(self, payload):
        stats = dict(self.transfer_stats)
        stats["chunk_cache_bytes"] = self._chunk_cache_bytes
        stats["object_pull_relayed_fraction"] = \
            self._pull_relayed_fraction()
        if payload and payload.get("include_read_log"):
            stats["read_log"] = list(self._chunk_read_log)
        return stats

    async def _delete_object(self, payload):
        # GCS-driven delete: its location record is already retracted,
        # so skip the on_delete location-remove echo.
        self._drop_cached_chunks(payload["object_id"])
        self.store.delete(payload["object_id"], notify=False)
        return True


def main():  # pragma: no cover — exercised via subprocess in tests
    import argparse
    import json
    import signal

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--monitor-pid", type=int, default=0,
                        help="exit when this process disappears")
    args = parser.parse_args()

    logging.basicConfig(
        level=global_config().log_level,
        format="[noded %(levelname)s %(asctime)s] %(message)s")
    manager = NodeManager(
        gcs_address=args.gcs_address,
        resources=json.loads(args.resources),
        session_dir=args.session_dir,
        port=args.port,
        labels=json.loads(args.labels),
    )
    manager.start()
    print(f"NODED_READY {manager.address}", flush=True)

    stop = False

    def _term(*_a):
        nonlocal stop
        # SIGTERM is an ANNOUNCED departure (the k8s/GCE preemption
        # path): best-effort drain announce so the head marks the node
        # DRAINING a beat before it vanishes; the announce is async and
        # must not delay the exit below.
        if not stop:
            try:
                manager.begin_drain("SIGTERM", deadline_s=5.0)
            except Exception:  # noqa: BLE001 — exiting regardless
                pass
        stop = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop:
        time.sleep(0.2)
        if args.monitor_pid and not os.path.exists(
                f"/proc/{args.monitor_pid}"):
            logger.warning("monitored pid %d gone; exiting", args.monitor_pid)
            break
    manager.stop()
    sys.exit(0)


if __name__ == "__main__":
    main()
