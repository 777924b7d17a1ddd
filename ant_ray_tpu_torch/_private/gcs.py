"""Global control store (GCS) — the cluster head.

Role of the reference's gcs_server (ref: src/ray/gcs/gcs_server.h:99): owns
the cluster tables (nodes, actors, jobs, named actors, KV, object directory),
performs actor scheduling, health-checks nodes, and answers placement
queries.  All handlers run on the single IO-thread event loop, so table
access needs no locks.  Storage is in-memory round 1 (the store-client
abstraction for Redis persistence comes with HA).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID
from ant_ray_tpu_torch._private.protocol import (
    ClientPool,
    IoThread,
    RpcServer,
    _spawn,
)
from ant_ray_tpu_torch._private.specs import (
    ACTOR_ALIVE,
    ACTOR_DEAD,
    ACTOR_PENDING,
    ACTOR_RESTARTING,
    ActorSpec,
    NodeInfo,
)

logger = logging.getLogger(__name__)


@dataclass
class ActorRecord:
    spec: ActorSpec
    state: str = ACTOR_PENDING
    address: str = ""             # worker RPC addr once alive
    node_id: NodeID | None = None
    restarts_used: int = 0
    death_reason: str = ""
    state_event: asyncio.Event = field(default_factory=asyncio.Event)


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store_path: str | None = None,
                 export_dir: str | None = None,
                 ha_replica_id: str | None = None):
        from ant_ray_tpu_torch._private.store_client import (  # noqa: PLC0415
            store_client_for,
        )

        # Export-event pipeline (ref: RayEventRecorder + export_*.proto
        # — durable JSONL lifecycle events for external pipelines);
        # active only when the session provides an export dir.
        self._exporter = None
        if export_dir:
            from ant_ray_tpu_torch._private.export_events import (  # noqa: PLC0415
                ExportEventRecorder,
            )

            self._exporter = ExportEventRecorder(export_dir)

        # Write-through persistence (ref: gcs store clients,
        # src/ray/gcs/store_client/redis_store_client.h): with a store
        # spec, every table mutation lands in the store and a restarted
        # head (same port + store) resumes the cluster — actors stay
        # callable, PGs stay reserved, nodes resync via heartbeats.
        # ``art-store://host:port`` targets the RPC'd store service
        # (store_server.py), which lives OFF this machine so a standby
        # head anywhere can restore the tables (shared-store HA).
        self._store = store_client_for(store_path)
        self._durable = store_path is not None
        # Replicated control plane (gcs_ha.HaCoordinator): with a
        # replica id AND a shared store, this process is one member of
        # a leader + warm-standby set — mutations are fenced on the
        # lease, standbys tail the store and serve follower reads.
        self._ha = None
        if ha_replica_id is not None:
            if not store_path:
                raise ValueError(
                    "GCS HA requires a shared store (--store)")
            from ant_ray_tpu_torch._private.gcs_ha import (  # noqa: PLC0415
                HaCoordinator,
            )

            self._ha = HaCoordinator(self, ha_replica_id, store_path)
        # Tables whose persisted copy lags in-memory truth by at most
        # one flush period (high-churn; see _location_flush_loop).
        self._dirty_nodes: set[NodeID] = set()
        self._metrics_dirty = False
        # Store-generation counter: bumped once per flush period in
        # which ANY table write happened, advertised in the leader ad —
        # followers skip the full table re-read when it hasn't moved,
        # so idle-cluster sync cost is O(1), not O(state).
        self._store_gen = 0
        self._store_gen_dirty = False
        self._server = RpcServer(host, port)
        self._nodes: dict[NodeID, NodeInfo] = {}
        self._last_heartbeat: dict[NodeID, float] = {}
        # Versioned resource-view sync: highest view version applied per
        # node (ref: ray_syncer NodeState version tracking).  Absent
        # after a restart -> the node is commanded to resync.
        self._node_view_versions: dict[NodeID, int] = {}
        self._spread_rr = 0       # SPREAD strategy round-robin cursor
        self._actors: dict[ActorID, ActorRecord] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}
        self._kv: dict[str, bytes] = {}
        self._object_locations: dict[ObjectID, set[NodeID]] = {}
        self._jobs: dict[JobID, dict] = {}
        self._placement_groups: dict = {}  # pg_id -> record dict
        self._metrics: dict[tuple, dict] = {}  # (name, tags) -> series
        # vc_id -> {"node_ids": set[NodeID], "divisible": bool, ...}
        # (ant-fork capability: GcsVirtualClusterManager,
        #  src/ray/gcs/gcs_virtual_cluster_manager.h:30)
        self._virtual_clusters: dict[str, dict] = {}
        self._job_vc: dict[JobID, str] = {}
        from collections import deque  # noqa: PLC0415

        # bounded ring of task lifecycle events (ref: the GCS task-event
        # aggregator fed by core-worker TaskEventBuffers)
        self._task_events: deque = deque(maxlen=50000)
        # bounded per-(task, attempt) state table folded at ingestion —
        # ListTasks/GetTask/SummarizeTasks answer from THIS, never by
        # replaying the raw ring (ref: GcsTaskManager's task table,
        # gcs_task_manager.h:97)
        from ant_ray_tpu_torch._private.task_state import (  # noqa: PLC0415
            TaskStateTable,
        )

        self._task_state = TaskStateTable()
        # client-side flush drops reported by TaskEventBuffers (each
        # TaskEventsAdd carries the producer's delta) — surfaced in the
        # state-API stats so a lossy view is never silent
        self._task_events_dropped = 0
        # object directory sidecar: owner address (+ optional creation
        # callsite) per object, reported by the sealing daemon — the
        # memory-attribution join reads it back via ListObjects
        self._object_meta: dict[ObjectID, dict] = {}
        # bounded ring of flow-insight events (ant-fork, util/insight)
        self._insight_events: deque = deque(maxlen=10000)
        # bounded ring of per-step profiler records (observability/
        # step_profiler.py — merged into the timeline as device rows)
        self._step_events: deque = deque(maxlen=20000)
        # bounded ring of request-trace spans (observability/
        # tracing_plane.py — batch-published per-process flight
        # recorders; /api/trace/{id} and the timeline read it back)
        self._span_events: deque = deque(maxlen=50000)
        # bounded ring of folded-stack CPU-profile deltas (observability/
        # cpu_profiler.py — one record per process per publish period;
        # the CLI `profile` capture and /api/cpuprofile read it back)
        self._cpu_profile: deque = deque(maxlen=4000)
        self._dirty_locations: set[ObjectID] = set()
        # ---- pubsub (ref: src/ray/pubsub/publisher.h — long-poll
        # channels; here one global sequence + per-event channel tag so a
        # subscriber resumes from a single cursor)
        self._pub_events: deque = deque(maxlen=4096)
        self._pub_seq = 0
        self._pub_cond: asyncio.Condition | None = None  # lazy (io loop)
        self._pub_notify_pending = False
        # Unfulfilled scheduling demands (autoscaler input): canonical
        # (resources, selector) -> {count, first_seen, last_seen}.
        self._demands: dict[str, dict] = {}
        # ---- scale observatory counters (benchmarks/scale_harness.py
        # reads these back via GetScaleStats to decompose control-plane
        # cost per node by subsystem) ----
        self._init_sched_observatory()
        # Heartbeat ingest: beats handled and versioned views applied.
        self._hb_stats = {"beats": 0, "views_applied": 0,
                          "unknown_node": 0}
        # Health ticks that judged nobody because they woke late
        # (_health_check_loop).
        self.health_ticks_deferred = 0
        # Long-pollers currently parked in _sub_poll (subscriber gauge).
        self._sub_pollers = 0
        # io-loop duty cursor: (io_samples, io_idle_samples) at the
        # last _io_loop_duty() reading, so each reading is a window
        # fraction instead of a since-boot average.
        self._io_duty_cursor = (0, 0)
        # None until the first heartbeat — 0.0 would read as "recently
        # seen" on a host whose monotonic clock is near boot.
        self._autoscaler_seen: float | None = None
        self._clients = ClientPool()
        self._io = IoThread.get()
        self._health_task = None
        self.address = ""

    # ------------------------------------------------------------- lifecycle

    def start(self) -> str:
        handlers = {
            "RegisterNode": self._register_node,
            "Heartbeat": self._heartbeat,
            "GetAllNodes": self._get_all_nodes,
            "ListNodes": self._list_nodes,
            "GetScaleStats": self._get_scale_stats,
            "DrainNode": self._drain_node,
            "KVPut": self._kv_put,
            "KVGet": self._kv_get,
            "KVDel": self._kv_del,
            "KVTake": self._kv_take,
            "KVKeys": self._kv_keys,
            "RegisterJob": self._register_job,
            "CreateActor": self._create_actor,
            "GetActorInfo": self._get_actor_info,
            "WaitActorAlive": self._wait_actor_alive,
            "GetNamedActor": self._get_named_actor,
            "KillActor": self._kill_actor,
            "ActorStateUpdate": self._actor_state_update,
            "WorkerDied": self._worker_died,
            "ObjectLocationAdd": self._object_location_add,
            "ObjectLocationRemove": self._object_location_remove,
            "ObjectLocationsGet": self._object_locations_get,
            "FreeObject": self._free_object,
            "SelectNode": self._select_node,
            "ResourceDemands": self._resource_demands,
            "AutoscalerHeartbeat": self._autoscaler_heartbeat,
            "AutoscalingEnabled": self._autoscaling_enabled,
            "ClusterResources": self._cluster_resources,
            "AvailableResources": self._available_resources,
            "CreatePlacementGroup": self._create_placement_group,
            "GetPlacementGroup": self._get_placement_group,
            "RemovePlacementGroup": self._remove_placement_group,
            "ListPlacementGroups": self._list_placement_groups,
            "ListActors": self._list_actors,
            "ListObjects": self._list_objects,
            "MetricRecord": self._metric_record,
            "MetricsGet": self._metrics_get,
            "CreateVirtualCluster": self._create_virtual_cluster,
            "RemoveVirtualCluster": self._remove_virtual_cluster,
            "UpdateVirtualCluster": self._update_virtual_cluster,
            "ListVirtualClusters": self._list_virtual_clusters,
            "SetJobVirtualCluster": self._set_job_virtual_cluster,
            "GetJobVirtualCluster": self._get_job_virtual_cluster,
            "InsightRecord": self._insight_record,
            "InsightGet": self._insight_get,
            "TaskEventsAdd": self._task_events_add,
            "TaskEventsGet": self._task_events_get,
            "ListTasks": self._list_tasks,
            "GetTask": self._get_task,
            "SummarizeTasks": self._summarize_tasks,
            "ListJobs": self._list_jobs,
            "StepEventsAdd": self._step_events_add,
            "StepEventsGet": self._step_events_get,
            "SpanEventsAdd": self._span_events_add,
            "SpanEventsGet": self._span_events_get,
            "CpuProfileAdd": self._cpu_profile_add,
            "CpuProfileGet": self._cpu_profile_get,
            "MetricsExpire": self._metrics_expire,
            "GetHaView": self._get_ha_view,
            "SubPoll": self._sub_poll,
            "PublishLogs": self._publish_logs,
            "ExportEventsGet": self._export_events_get,
            "Shutdown": self._shutdown_rpc,
        }
        if self._ha is not None:
            # Fence leader-only methods; reads and ring writes stay
            # servable on any replica (split defined in wire_schema).
            handlers = self._ha.guard_routes(handlers)
        self._server.routes(handlers)
        if self._durable and self._ha is None:
            # Plain restart-FT: re-hydrate before serving.  HA replicas
            # re-hydrate continuously (standby sync loop) and fully at
            # promotion instead.
            self._load_tables()
        self.address = self._server.start()
        self._health_task = asyncio.run_coroutine_threadsafe(
            self._health_check_loop(), self._io.loop)
        if self._durable:
            self._flush_task = asyncio.run_coroutine_threadsafe(
                self._location_flush_loop(), self._io.loop)
        if self._ha is not None:
            self._ha.start()
        # Continuous CPU profiling: the GCS ingests its own records —
        # the publisher appends straight into the local ring (each HA
        # replica keeps its own shard; CpuProfileGet merges at query
        # time) and metric rollups run through the local handler on the
        # io loop.  Instance profiler, not the module singleton: HA
        # tests run several replicas in one process.
        from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

        self._cpu_profiler = None
        if global_config().cpu_profile_hz > 0:
            def _publish_profile(record, server=self):
                server._cpu_profile.append(record)

            def _publish_metric(payload, server=self):
                asyncio.run_coroutine_threadsafe(
                    server._metric_record(payload), server._io.loop)

            self._cpu_profiler = cpu_profiler.CpuProfiler(
                "gcs", publish_fn=_publish_profile,
                metric_fn=_publish_metric,
                node_id=(f"gcs-{self._ha.replica_id}"
                         if self._ha is not None else "gcs")).start()
        logger.info("GCS listening on %s%s", self.address,
                    f" (HA replica {self._ha.replica_id})"
                    if self._ha is not None else "")
        return self.address

    def _leading(self) -> bool:
        """True when this process owns the cluster (non-HA, or the HA
        leader): the health-check and flush loops no-op on standbys."""
        return self._ha is None or self._ha.is_leader_active()

    async def _get_ha_view(self, _payload):
        if self._ha is None:
            return {"ha": False, "role": "leader",
                    "replica_id": None, "address": self.address,
                    "leader": self.address, "term": 0,
                    "last_failover_ts": None,
                    "replication_lag_s": None, "replicas": []}
        return self._ha.view()

    # ---------------------------------------------------- persistence

    def _persist(self, table: str, key: str, value) -> None:
        if self._durable:
            import pickle  # noqa: PLC0415

            self._store.put(table, key, pickle.dumps(value))
            self._store_gen_dirty = True

    def _persist_del(self, table: str, key: str) -> None:
        if self._durable:
            self._store.delete(table, key)
            self._store_gen_dirty = True

    def _save_actor(self, record: ActorRecord) -> None:
        self._persist("actors", record.spec.actor_id.hex(), {
            "spec": record.spec, "state": record.state,
            "address": record.address, "node_id": record.node_id,
            "restarts_used": record.restarts_used,
            "death_reason": record.death_reason,
        })

    def _save_pg(self, record: dict) -> None:
        self._persist("pgs", record["pg_id"].hex(), record)

    def _save_locations(self, oid) -> None:
        # Object-location churn is the hottest GCS path — a synchronous
        # sqlite commit per event would serialize the whole object plane
        # behind the disk.  Mark dirty; a periodic flusher batches the
        # writes (restart loses at most one flush period of location
        # updates, which heartbeat resync / lineage absorbs).
        if self._durable:
            self._dirty_locations.add(oid)

    async def _location_flush_loop(self):
        while True:
            await asyncio.sleep(0.5)
            if not self._leading():
                continue        # standbys tail the store, never write it
            self._flush_locations()
            self._flush_nodes()
            self._flush_metrics()
            if self._store_gen_dirty:
                self._store_gen_dirty = False
                self._store_gen += 1
            if self._ha is not None:
                # Leader heartbeat into the store: redirect target +
                # the wall-clock stamp followers measure lag against +
                # the store generation they sync against.
                self._ha.write_leader_ad()

    def _flush_locations(self) -> None:
        if not self._durable or not self._dirty_locations:
            return
        dirty, self._dirty_locations = self._dirty_locations, set()
        for oid in dirty:
            nodes = self._object_locations.get(oid)
            if nodes:
                self._persist("locations", oid.hex(), (oid, nodes))
            else:
                self._persist_del("locations", oid.hex())

    def _save_node(self, info: NodeInfo) -> None:
        """Immediate node-table persistence for the low-churn
        transitions (register / death / drain); the high-churn
        availability view rides the dirty set + flush loop instead."""
        self._persist("nodes", info.node_id.hex(), info)

    def _flush_nodes(self) -> None:
        if not self._durable or not self._dirty_nodes:
            return
        dirty, self._dirty_nodes = self._dirty_nodes, set()
        for node_id in dirty:
            info = self._nodes.get(node_id)
            if info is not None:
                self._persist("nodes", node_id.hex(), info)

    def _flush_metrics(self) -> None:
        """One pickled blob per flush period when anything changed:
        followers serve metrics scrapes from it, and a restarted head
        resumes its counters instead of zeroing every series."""
        if not self._durable or not self._metrics_dirty:
            return
        self._metrics_dirty = False
        self._persist("misc", "metrics", self._metrics)

    def _save_vcs(self) -> None:
        self._persist("misc", "virtual_clusters", self._virtual_clusters)
        self._persist("misc", "job_vc", self._job_vc)

    def _snapshot_tables_from_store(self) -> dict:
        """Read every persisted table into fresh containers (no side
        effects, callable off the io loop): the follower sync loop and
        the (re)start/promotion loaders share this one reader."""
        import pickle  # noqa: PLC0415

        store = self._store
        snap: dict = {}
        snap["kv"] = {key: pickle.loads(blob)
                      for key, blob in store.load_table("kv").items()}
        jobs = {}
        for _key, blob in store.load_table("jobs").items():
            job_id, info = pickle.loads(blob)
            jobs[job_id] = info
        snap["jobs"] = jobs
        actors: dict = {}
        named: dict = {}
        for _key, blob in store.load_table("actors").items():
            row = pickle.loads(blob)
            record = ActorRecord(
                spec=row["spec"], state=row["state"],
                address=row["address"], node_id=row["node_id"],
                restarts_used=row["restarts_used"],
                death_reason=row["death_reason"])
            actors[record.spec.actor_id] = record
            if record.spec.name and record.state != ACTOR_DEAD:
                named[(record.spec.namespace, record.spec.name)] = \
                    record.spec.actor_id
        snap["actors"] = actors
        snap["named_actors"] = named
        pgs = {}
        for _key, blob in store.load_table("pgs").items():
            record = pickle.loads(blob)
            pgs[record["pg_id"]] = record
        snap["pgs"] = pgs
        locations = {}
        for _key, blob in store.load_table("locations").items():
            oid, nodes = pickle.loads(blob)
            locations[oid] = nodes
        snap["locations"] = locations
        blob = store.get("misc", "virtual_clusters")
        snap["vcs"] = pickle.loads(blob) if blob else {}
        blob = store.get("misc", "job_vc")
        snap["job_vc"] = pickle.loads(blob) if blob else {}
        nodes = {}
        for _key, blob in store.load_table("nodes").items():
            info = pickle.loads(blob)
            nodes[info.node_id] = info
        snap["nodes"] = nodes
        blob = store.get("misc", "metrics")
        snap["metrics"] = pickle.loads(blob) if blob else {}
        return snap

    def _apply_table_snapshot(self, snap: dict) -> None:
        """Swap the snapshot in (io-loop only): whole-container
        assignment, so a concurrently-dispatched read handler sees
        either the previous generation or this one, never a mix."""
        self._kv = snap["kv"]
        self._jobs = snap["jobs"]
        self._actors = snap["actors"]
        self._named_actors = snap["named_actors"]
        self._placement_groups = snap["pgs"]
        self._object_locations = snap["locations"]
        self._virtual_clusters = snap["vcs"]
        self._job_vc = snap["job_vc"]
        self._nodes = snap["nodes"]
        self._metrics = snap["metrics"]

    def _load_tables(self) -> None:
        """Full re-hydrate + activation (restart FT): load every table,
        then activate.  HA promotion snapshots OFF the io loop first
        (a remote store's reads block on that very loop) and calls
        :meth:`_activate_tables` directly."""
        self._activate_tables(self._snapshot_tables_from_store())

    def _activate_tables(self, snap: dict) -> None:
        """Adopt a snapshot and kick the schedulers/reconcilers that a
        passive follower sync must never run."""
        self._apply_table_snapshot(snap)
        # Restored nodes get one full heartbeat-timeout of grace before
        # the health check may declare them dead; their view versions
        # are gone, so the next beat is answered with a resync command.
        now = time.monotonic()
        for node_id in self._nodes:
            self._last_heartbeat[node_id] = now
        self._node_view_versions = {}
        for record in self._actors.values():
            # Actors that were mid-scheduling when the head died get
            # re-kicked once the loop runs (nodes resync via heartbeat).
            if record.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                asyncio.run_coroutine_threadsafe(
                    self._reschedule_after_resync(record), self._io.loop)
        for record in self._placement_groups.values():
            if record["state"] == "PENDING":
                asyncio.run_coroutine_threadsafe(
                    self._schedule_placement_group(record), self._io.loop)
        # Liveness reconciliation: an actor restored as ALIVE may sit on
        # a node that never comes back (its daemon died during the head's
        # downtime, so no WorkerDied report will ever arrive).  After a
        # registration grace period, fail those actors through the normal
        # restart machinery.
        if any(r.state in (ACTOR_ALIVE, ACTOR_RESTARTING)
               for r in self._actors.values()):
            asyncio.run_coroutine_threadsafe(
                self._reconcile_actors_after_restart(), self._io.loop)
        logger.info(
            "restored GCS state: %d actors, %d pgs, %d kv keys, %d jobs"
            ", %d nodes",
            len(self._actors), len(self._placement_groups),
            len(self._kv), len(self._jobs), len(self._nodes))

    async def _reschedule_after_resync(self, record: ActorRecord):
        # Give nodes one heartbeat round to re-register before placing.
        await asyncio.sleep(global_config().heartbeat_period_s * 2)
        await self._schedule_actor(record)

    async def _reconcile_actors_after_restart(self):
        cfg = global_config()
        await asyncio.sleep(
            cfg.heartbeat_period_s * cfg.num_heartbeats_timeout)
        for record in list(self._actors.values()):
            if record.state not in (ACTOR_ALIVE, ACTOR_RESTARTING):
                continue
            node = (self._nodes.get(record.node_id)
                    if record.node_id is not None else None)
            if node is None or not node.alive:
                await self._handle_actor_failure(
                    record, "node lost while the head was down")

    def stop(self, graceful: bool = True):
        """``graceful=False`` (the subprocess SIGTERM path) skips waits
        that need io-loop turns: the loop may be busy reacting to the
        same cluster teardown (node deaths), and the dying process's
        sockets close with it anyway."""
        profiler = getattr(self, "_cpu_profiler", None)
        if profiler is not None:
            self._cpu_profiler = None
            profiler.stop(final_publish=False)
        if self._health_task is not None:
            self._health_task.cancel()
        if self._ha is not None:
            # Releases a held lease so a standby takes over immediately
            # (graceful failover) instead of waiting out the TTL.
            self._ha.stop()
        flush_task = getattr(self, "_flush_task", None)
        if flush_task is not None:
            flush_task.cancel()
            self._flush_locations()  # final batch before shutdown
            self._flush_nodes()
            self._flush_metrics()
        # Drain the store's async write queue: acknowledged mutations
        # must reach the (possibly remote) store before the head exits.
        self._store.close()
        if self._exporter is not None:
            # Terminal lifecycle events (node DEAD, worker DIED) queue
            # milliseconds before shutdown; os._exit in main would drop
            # them from the JSONL files the pipeline promises.
            self._exporter.flush(timeout=2.0)
        if graceful:
            self._server.stop()
            self._clients.close_all()

    async def _shutdown_rpc(self, _payload):
        loop = asyncio.get_running_loop()
        loop.call_later(0.05, self.stop)
        return True

    # ------------------------------------------------------------- pubsub

    def _publish(self, channel: str, data: dict) -> None:
        """Append an event and wake long-pollers (ref: Publisher,
        src/ray/pubsub/publisher.h — the mechanism that lets a thousand
        workers watch actor/node state without hammering the head).
        Wakeups coalesce: a burst of publishes (mass node failure)
        schedules ONE notify, not one per event."""
        self._pub_seq += 1
        self._pub_events.append((self._pub_seq, channel, data))
        if self._exporter is not None and channel != "worker_logs":
            # Mirror control-plane pubsub into the export pipeline:
            # node alive/dead and actor state transitions ARE the
            # lifecycle events external consumers want.
            if channel == "node":
                self._exporter.record(
                    "EXPORT_NODE",
                    "ALIVE" if data.get("alive") else "DEAD",
                    data.get("node_id"), data)
            elif channel == "actor_state":
                self._exporter.record("EXPORT_ACTOR",
                                      str(data.get("state", "")).upper(),
                                      data.get("actor_id"), data)
        if self._pub_cond is not None and not self._pub_notify_pending:
            self._pub_notify_pending = True

            async def _notify():
                self._pub_notify_pending = False
                async with self._pub_cond:
                    self._pub_cond.notify_all()

            _spawn(_notify())

    async def _export_events_get(self, payload):
        """Read back export-pipeline events (dashboard /api and tests;
        external pipelines normally tail the JSONL files directly).
        File parsing runs off the event loop — a full export dir must
        not stall heartbeats and lease RPCs."""
        if self._exporter is None:
            return {"enabled": False, "events": []}
        events = await asyncio.to_thread(
            self._exporter.read, payload.get("source_type"),
            int(payload.get("limit", 1000)))
        return {"enabled": True, "events": events}

    async def _publish_logs(self, payload):
        """Fan worker stdout/stderr lines out to subscribed drivers
        (ref: log_monitor.py → GCS pubsub — the mechanism behind
        `print()` in a task appearing on the driver's console)."""
        self._publish("worker_logs", payload)
        return True

    async def _sub_poll(self, payload):
        """Long-poll subscription: blocks until events newer than the
        caller's cursor exist on its channels (or ~25s passes), then
        returns them with the new cursor."""
        if self._pub_cond is None:
            self._pub_cond = asyncio.Condition()
        channels = set(payload.get("channels") or ())
        cursor = int(payload.get("cursor", 0))
        if cursor < 0:  # "start from now" — skip buffered history
            cursor = self._pub_events[-1][0] if self._pub_events else 0
        elif cursor > self._pub_seq:
            # A cursor ahead of our sequence belongs to a previous
            # leader incarnation (the client's router absorbed the
            # failover, so its error-path resubscribe never ran).
            # Adopt "now" — resuming with the foreign cursor would
            # silence the subscription forever.
            cursor = self._pub_seq
        timeout = min(float(payload.get("timeout", 25.0)), 25.0)
        deadline = time.monotonic() + timeout
        self._sub_pollers += 1
        try:
            while True:
                events = [(seq, ch, data)
                          for seq, ch, data in self._pub_events
                          if seq > cursor
                          and (not channels or ch in channels)]
                latest = (self._pub_events[-1][0]
                          if self._pub_events else cursor)
                if events:
                    return {"cursor": max(cursor, latest),
                            "events": events}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"cursor": max(cursor, latest), "events": []}
                async with self._pub_cond:
                    try:
                        await asyncio.wait_for(self._pub_cond.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        pass
        finally:
            self._sub_pollers -= 1

    # ------------------------------------------------------------- nodes

    async def _register_node(self, info: NodeInfo):
        self._nodes[info.node_id] = info
        self._last_heartbeat[info.node_id] = time.monotonic()
        self._save_node(info)
        # (Re-)registration carries a fresh full view and restarts the
        # node's version counter — drop any stale high-water mark so the
        # node's next deltas aren't rejected as old.
        self._node_view_versions.pop(info.node_id, None)
        self._publish("node", {"node_id": info.node_id, "alive": True,
                               "address": info.address})
        logger.info("node %s registered at %s", info.node_id.hex()[:8],
                    info.address)
        return True

    async def _heartbeat(self, payload):
        """Liveness + versioned resource-view sync (ref:
        src/ray/ray_syncer/ray_syncer.h:90).  A beat without a ``view``
        is pure liveness; one WITH a view applies it if its version is
        newer than what we hold and acks the version, so the node stops
        resending.  After a GCS restart our version table is empty —
        the ``resync`` command tells the node to send a full view."""
        node_id = payload["node_id"]
        self._hb_stats["beats"] += 1
        info = self._nodes.get(node_id)
        if info is None:
            self._hb_stats["unknown_node"] += 1
            return {"unknown_node": True}  # node must re-register
        self._last_heartbeat[node_id] = time.monotonic()
        reply: dict = {}
        view = payload.get("view")
        if view is not None:
            version = view.get("version", 0)
            if version > self._node_view_versions.get(node_id, -1):
                self._hb_stats["views_applied"] += 1
                info.available_resources = view["available_resources"]
                info.disk_full = view.get("disk_full", False)
                # Drain state is STICKY here: the daemon's view can set
                # it (preemption watcher), but never clears it — a node
                # drained via the DrainNode RPC stays drained even if
                # the daemon itself didn't observe the notice.
                if view.get("draining"):
                    self._apply_drain(info, view.get("drain_reason", ""),
                                      view.get("drain_deadline", 0.0))
                self._node_view_versions[node_id] = version
                self._dirty_nodes.add(node_id)
            reply["synced"] = self._node_view_versions[node_id]
        elif node_id not in self._node_view_versions:
            reply["commands"] = ["resync"]
        if "available_resources" in payload:   # legacy full-view beat
            info.available_resources = payload["available_resources"]
            info.disk_full = payload.get("disk_full", False)
        return reply

    async def _get_all_nodes(self, _payload):
        return dict(self._nodes)

    @staticmethod
    def _node_state(info: NodeInfo) -> str:
        if not info.alive:
            return "DEAD"
        if getattr(info, "draining", False):
            return "DRAINING"
        return "ALIVE"

    async def _list_nodes(self, payload):
        """Paginated node listing — the ListTasks cursor idiom applied
        to the node table (the unpaged GetAllNodes reply falls over at
        hundreds of nodes).  Pages walk node-id order; the token is the
        last returned node's hex id, so a node dying (or registering)
        between pages can neither shift nor duplicate the cursor.
        ``state`` filters ALIVE / DEAD / DRAINING server-side."""
        payload = payload or {}
        limit = max(1, int(payload.get("limit", 1000)))
        state = payload.get("state")
        if state is not None:
            state = str(state).upper()
        token = payload.get("token")
        records = []
        next_token = None
        total = matched = 0
        for node_id in sorted(self._nodes, key=lambda n: n.hex()):
            total += 1
            info = self._nodes[node_id]
            node_state = self._node_state(info)
            if state is not None and node_state != state:
                continue
            matched += 1
            if token is not None and node_id.hex() <= token:
                continue
            if len(records) >= limit:
                next_token = records[-1]["node_id"]
                break
            records.append({
                "node_id": node_id.hex(),
                "address": info.address,
                "state": node_state,
                "alive": info.alive,
                "draining": bool(getattr(info, "draining", False)),
                "drain_reason": getattr(info, "drain_reason", ""),
                "disk_full": bool(getattr(info, "disk_full", False)),
                "labels": dict(info.labels or {}),
                "total_resources": dict(info.total_resources),
                "available_resources": dict(info.available_resources),
            })
        return {"nodes": records, "next_token": next_token,
                "total": total, "matched": matched}

    # ------------------------------------------- scale observatory
    # (benchmarks/scale_harness.py + /api/scale + `scale-report`: the
    # per-subsystem cost decomposition that turns "cost per node" from
    # one opaque number into attributable curves)

    def _io_loop_duty(self) -> float | None:
        """Busy fraction of the io thread over the window since the
        last call, derived from the always-on CPU profiler's folded
        stacks: an io-thread sample whose leaf is the selector wait is
        idle; anything else is the loop doing work.  None when the
        profiling plane is off (``cpu_profile_hz`` 0) or no io samples
        landed yet."""
        prof = getattr(self, "_cpu_profiler", None)
        if prof is None:
            return None
        total = idle = 0
        for key, count in prof.snapshot().items():
            parts = key.split(";")
            if len(parts) < 3 or parts[1] != "art-io":
                continue
            total += count
            leaf = parts[-1]
            if ":select" in leaf or ":poll" in leaf:
                idle += count
        last_total, last_idle = self._io_duty_cursor
        self._io_duty_cursor = (total, idle)
        window = total - last_total
        if window <= 0:
            return None
        return 1.0 - (idle - last_idle) / window

    def _scale_stats(self) -> dict:
        from ant_ray_tpu_torch._private import protocol  # noqa: PLC0415

        return {
            "table_rows": {
                "nodes": len(self._nodes),
                "actors": len(self._actors),
                "jobs": len(self._jobs),
                "objects": len(self._object_locations),
                "placement_groups": len(self._placement_groups),
                "metrics": len(self._metrics),
                "kv": len(self._kv),
                "tasks": self._task_state.stats().get("num_records", 0),
                "virtual_clusters": len(self._virtual_clusters),
            },
            "rings": {
                "task_events": len(self._task_events),
                "step_events": len(self._step_events),
                "span_events": len(self._span_events),
                "cpu_profile": len(self._cpu_profile),
                "pub_events": len(self._pub_events),
                "insight_events": len(self._insight_events),
            },
            "subscribers": self._sub_pollers,
            "sched": dict(self._sched_stats),
            "heartbeat": dict(self._hb_stats),
            # method -> [calls, handle_ns]: this process's server-side
            # dispatch→reply cost per RPC method (protocol.py).
            "handle": {m: list(v) for m, v in
                       protocol.handle_counters.items()},
            "io_loop_duty": self._io_loop_duty(),
        }

    async def _get_scale_stats(self, _payload):
        return self._scale_stats()

    async def _publish_self_metrics(self) -> None:
        """Fold the scale-stats snapshot into the metrics table as the
        ``art_gcs_*`` gauge set (scrapeable via /metrics like any other
        series).  Runs on the health-loop cadence; ~20 gauge upserts."""
        stats = self._scale_stats()
        node = (f"gcs-{self._ha.replica_id}"
                if self._ha is not None else "gcs")
        for table, rows in stats["table_rows"].items():
            await self._metric_record({
                "name": "art_gcs_table_rows", "type": "gauge",
                "value": float(rows),
                "tags": {"table": table, "node_id": node},
                "description": "GCS cluster-table row counts"})
        for ring, occupancy in stats["rings"].items():
            await self._metric_record({
                "name": "art_gcs_ring_len", "type": "gauge",
                "value": float(occupancy),
                "tags": {"ring": ring, "node_id": node},
                "description": "GCS bounded event-ring occupancy"})
        await self._metric_record({
            "name": "art_gcs_subscribers", "type": "gauge",
            "value": float(stats["subscribers"]),
            "tags": {"node_id": node},
            "description": "Parked pubsub long-pollers"})
        duty = stats["io_loop_duty"]
        if duty is not None:
            await self._metric_record({
                "name": "art_gcs_io_loop_duty", "type": "gauge",
                "value": round(duty, 4),
                "tags": {"node_id": node},
                "description": "GCS io-loop busy fraction (profiler-"
                               "derived, current window)"})

    # ------------------------------------------------------------- drain
    # (ref: the reference's DrainNode RPC + autoscaler drain protocol,
    #  gcs.proto DrainNodeRequest — here the announced-departure plane
    #  behind TPU maintenance events / preemption notices)

    def _apply_drain(self, info: NodeInfo, reason: str,
                     deadline: float) -> None:
        """Idempotent drain transition: publishes exactly once."""
        if info.draining:
            # Keep the earliest-announced deadline; a later notice
            # cannot push the departure time OUT.
            if deadline and (not info.drain_deadline
                             or deadline < info.drain_deadline):
                info.drain_deadline = deadline
            return
        info.draining = True
        info.drain_reason = reason
        info.drain_deadline = deadline
        self._save_node(info)
        self._publish("node", {"node_id": info.node_id, "alive": True,
                               "draining": True, "reason": reason,
                               "deadline": deadline,
                               "address": info.address})
        logger.info("node %s DRAINING (%s, deadline=%s)",
                    info.node_id.hex()[:8], reason or "unspecified",
                    deadline or "none")

    async def _drain_node(self, payload):
        """Put a node into DRAINING: schedulers skip it for new leases
        and bundle placements, Serve migrates its replicas, and Train
        controllers proactively checkpoint + relaunch gangs off it.
        The node stays ALIVE (its current work keeps running) until it
        actually departs."""
        info = self._nodes.get(payload["node_id"])
        if info is None or not info.alive:
            return False
        self._apply_drain(info, payload.get("reason", ""),
                          float(payload.get("deadline") or 0.0))
        return True

    async def _health_check_loop(self):
        """Marks a node dead once its last beat is older than
        ``heartbeat_period_s * num_heartbeats_timeout``.

        Deliberately unlike the JAX package's loop: a tick that woke
        more than one period late judges nobody.  Its lateness is this
        process's own stall (the io loop held elsewhere), and the beats
        that queued on the sockets meanwhile are read only after this
        tick yields — judged now, a live node would die of the GCS's
        stall.  The next tick judges whatever its own timing, so a node
        whose beats really stopped is still marked dead within the
        timeout plus two periods."""
        cfg = global_config()
        period = cfg.heartbeat_period_s
        timeout = cfg.heartbeat_period_s * cfg.num_heartbeats_timeout
        self_metrics_every = max(1, int(round(2.0 / period)))
        ticks = 0
        deferred = False
        due = time.monotonic() + period
        while True:
            await asyncio.sleep(max(0.0, due - time.monotonic()))
            ticks += 1
            late = time.monotonic() - due
            due = time.monotonic() + period
            if late > period and not deferred:
                deferred = True
                self.health_ticks_deferred += 1
                logger.warning("health check woke %.2f s late; judging "
                               "liveness on the next tick", late)
                continue
            deferred = False
            if ticks % self_metrics_every == 0:
                try:  # observability must never stall liveness judging
                    await self._publish_self_metrics()
                except Exception:  # noqa: BLE001 — best-effort gauges
                    pass
            if not self._leading():
                continue    # standbys observe, only the leader judges
            now = time.monotonic()
            for node_id, info in list(self._nodes.items()):
                # Nodes synced from the store while standing by have no
                # beat record yet — grant one from first sight.
                last = self._last_heartbeat.setdefault(node_id, now)
                if info.alive and now - last > timeout:
                    logger.warning("node %s missed heartbeats; marking dead",
                                   node_id.hex()[:8])
                    await self._on_node_death(node_id)

    async def _on_node_death(self, node_id: NodeID):
        info = self._nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        self._save_node(info)
        self._publish("node", {"node_id": node_id, "alive": False,
                               "address": info.address})
        self._expire_node_metrics(node_id)
        for oid, nodes in list(self._object_locations.items()):
            nodes.discard(node_id)
        for record in list(self._actors.values()):
            if record.node_id == node_id and record.state in (
                    ACTOR_ALIVE, ACTOR_PENDING, ACTOR_RESTARTING):
                await self._handle_actor_failure(record, "node died")

    # ----------------------------------------------- virtual clusters
    # Multi-tenant partitioning of the physical cluster (ant-fork
    # capability, ref: gcs_virtual_cluster.h:154 DivisibleCluster /
    # IndivisibleCluster; the unassigned remainder acts as the
    # PrimaryCluster).  Jobs bound to a VC schedule only on its nodes;
    # unbound jobs schedule only on unassigned nodes.

    def _assigned_node_ids(self) -> set:
        out: set = set()
        for record in self._virtual_clusters.values():
            out |= record["node_ids"]
        return out

    def _allowed_nodes_for_job(self, job_id) -> set | None:
        """Node-id set a job may use, or None for 'no restriction'
        (no VCs exist at all)."""
        if not self._virtual_clusters:
            return None
        vc_id = self._job_vc.get(job_id) if job_id is not None else None
        if vc_id is not None and vc_id in self._virtual_clusters:
            return set(self._virtual_clusters[vc_id]["node_ids"])
        alive = {n.node_id for n in self._nodes.values() if n.alive}
        return alive - self._assigned_node_ids()

    async def _create_virtual_cluster(self, payload):
        vc_id = payload["vc_id"]
        if vc_id in self._virtual_clusters:
            return {"error": f"virtual cluster {vc_id!r} exists"}
        node_ids = set(payload.get("node_ids") or [])
        num_nodes = payload.get("num_nodes")
        taken = self._assigned_node_ids()
        if num_nodes is not None and not node_ids:
            free = [n.node_id for n in self._nodes.values()
                    if n.alive and n.node_id not in taken]
            if len(free) < num_nodes:
                return {"error": f"only {len(free)} unassigned nodes "
                                 f"available, need {num_nodes}"}
            node_ids = set(free[:num_nodes])
        conflicts = node_ids & taken
        if conflicts:
            return {"error": "node(s) already assigned to another "
                             "virtual cluster"}
        bad = {n for n in node_ids
               if n not in self._nodes or not self._nodes[n].alive}
        if bad:
            return {"error": f"unknown or dead node id(s): "
                             f"{[n.hex()[:8] for n in bad]}"}
        self._virtual_clusters[vc_id] = {
            "node_ids": node_ids,
            "divisible": bool(payload.get("divisible", False)),
            "created_at": time.time(),
        }
        self._save_vcs()
        return {"vc_id": vc_id,
                "node_ids": [n.hex() for n in node_ids]}

    async def _remove_virtual_cluster(self, payload):
        removed = self._virtual_clusters.pop(payload["vc_id"], None)
        for job_id, vc in list(self._job_vc.items()):
            if vc == payload["vc_id"]:
                del self._job_vc[job_id]
        self._save_vcs()
        return removed is not None

    async def _update_virtual_cluster(self, payload):
        record = self._virtual_clusters.get(payload["vc_id"])
        if record is None:
            return {"error": "no such virtual cluster"}
        add = set(payload.get("add_nodes") or [])
        conflicts = add & (self._assigned_node_ids() - record["node_ids"])
        if conflicts:
            return {"error": "node(s) already assigned elsewhere"}
        bad = {n for n in add
               if n not in self._nodes or not self._nodes[n].alive}
        if bad:
            return {"error": f"unknown or dead node id(s): "
                             f"{[n.hex()[:8] for n in bad]}"}
        record["node_ids"] |= add
        record["node_ids"] -= set(payload.get("remove_nodes") or [])
        self._save_vcs()
        return {"node_ids": [n.hex() for n in record["node_ids"]]}

    async def _list_virtual_clusters(self, _payload):
        return {
            vc_id: {"node_ids": [n.hex() for n in r["node_ids"]],
                    "divisible": r["divisible"],
                    "jobs": [j.hex() for j, v in self._job_vc.items()
                             if v == vc_id]}
            for vc_id, r in self._virtual_clusters.items()
        }

    async def _set_job_virtual_cluster(self, payload):
        vc_id = payload.get("vc_id")
        if vc_id is None:
            self._job_vc.pop(payload["job_id"], None)
            self._save_vcs()
            return True
        if vc_id not in self._virtual_clusters:
            return {"error": f"no virtual cluster {vc_id!r}"}
        self._job_vc[payload["job_id"]] = vc_id
        self._save_vcs()
        return True

    async def _get_job_virtual_cluster(self, payload):
        allowed = self._allowed_nodes_for_job(payload["job_id"])
        return {
            "vc_id": self._job_vc.get(payload["job_id"]),
            "allowed_node_ids": (None if allowed is None
                                 else [n.hex() for n in allowed]),
        }

    # --------------------------------------------------- flow insight

    async def _insight_record(self, payload):
        self._insight_events.append(payload)
        return True

    async def _insight_get(self, payload):
        limit = int(payload.get("limit", 1000))
        events = list(self._insight_events)
        return events[-limit:]

    # ------------------------------------------------------ task events

    async def _task_events_add(self, payload):
        events = payload.get("events", ())
        self._task_events.extend(events)
        # Fold into the bounded state table AT INGESTION (one dict
        # upsert per event — benched by task_state_ingest_overhead_ns;
        # this path must stay cheap, see the export gate below).
        fold = self._task_state.apply
        for ev in events:
            fold(ev)
        dropped = payload.get("dropped")
        if dropped:
            self._task_events_dropped += int(dropped)
        if self._exporter is not None and \
                global_config().export_task_events:
            # Off by default, like the reference's per-source
            # enable_export_api_write gates: task events are the one
            # high-volume source, and recording each one costs ~40%% of
            # async task throughput on a small head.
            for ev in events:
                self._exporter.record("EXPORT_TASK",
                                      str(ev.get("event", "")).upper(),
                                      ev.get("task_id"), ev)
        return True

    async def _task_events_get(self, payload):
        payload = payload or {}
        limit = int(payload.get("limit", 50000))
        task_id = payload.get("task_id")
        events = list(self._task_events)
        if task_id is not None:
            events = [e for e in events if e.get("task_id") == task_id]
        if self._ha is not None and not payload.get("local_only"):
            # Sharded ring: merge every live replica's local slice
            # (producers spread their flushes across replicas).
            for peer_events in await self._ha.gather_ring(
                    "TaskEventsGet", payload):
                events.extend(peer_events)
            events.sort(key=lambda e: e.get("ts") or 0.0)
        return events[-limit:]

    # ---------------------------------------------- task state API
    # (ref: ray.util.state's state_aggregator path — list/summarize
    #  answered from the GCS-side folded table with server-side
    #  filtering; the client never pulls the raw event ring)

    def _state_stats(self) -> dict:
        return {"num_tasks_dropped": self._task_state.num_tasks_dropped,
                "task_events_dropped": self._task_events_dropped,
                **self._task_state.stats()}

    async def _merged_task_records(self,
                                   filters: dict) -> tuple[list, int, int]:
        """HA fan-in for the state API: this replica's records plus
        every live peer's (``local_only`` fan-out), merged with
        sticky-terminal semantics, THEN filtered — filtering per
        replica before the merge would let a ``state=RUNNING`` query
        resurface a task another replica knows FAILED.  Returns
        (records, dropped, events_dropped) with the drop counters
        summed across replicas — a clipped view stays visibly
        clipped after the merge."""
        from ant_ray_tpu_torch._private.task_state import (  # noqa: PLC0415
            TaskStateTable,
            merge_public_records,
        )

        local = self._task_state.list(filters={}, limit=1 << 30)
        lists = [local["tasks"]]
        dropped = local["num_tasks_dropped"]
        events_dropped = self._task_events_dropped
        for reply in await self._ha.gather_ring(
                "ListTasks", {"limit": 1 << 30}):
            lists.append(reply.get("tasks"))
            dropped += reply.get("num_tasks_dropped", 0)
            events_dropped += reply.get("task_events_dropped", 0)
        merged = [r for r in merge_public_records(lists)
                  if TaskStateTable._matches(r, filters)]
        return merged, dropped, events_dropped

    async def _list_tasks(self, payload):
        payload = payload or {}
        filters = {k: payload.get(k)
                   for k in ("state", "name", "job_id", "actor_id",
                             "node_id")}
        limit = max(1, int(payload.get("limit", 1000)))
        if self._ha is not None and not payload.get("local_only"):
            records, dropped, events_dropped = \
                await self._merged_task_records(filters)
            # Offset-style continuation over the deterministically-
            # sorted merged view (the single-replica seq cursor cannot
            # span replicas); the token stays an opaque int either way.
            # Known HA-mode tradeoffs, acceptable at the bounded table
            # sizes (task_table_max_per_job): each page re-runs the
            # full fan-in (no cross-page snapshot), and GC between
            # pages can shift offsets — unlike the eviction-safe
            # single-replica cursor.
            offset = int(payload.get("token") or 0)
            page = records[offset:offset + limit]
            next_token = (offset + limit
                          if offset + limit < len(records) else None)
            return {"tasks": page, "next_token": next_token,
                    "num_tasks_dropped": dropped,
                    "task_events_dropped": events_dropped}
        reply = self._task_state.list(
            filters=filters,
            limit=limit,
            token=payload.get("token"))
        reply["task_events_dropped"] = self._task_events_dropped
        return reply

    async def _get_task(self, payload):
        attempts = self._task_state.get(payload["task_id"])
        if self._ha is not None and not payload.get("local_only"):
            from ant_ray_tpu_torch._private.task_state import (  # noqa: PLC0415
                merge_public_records,
            )

            lists = [attempts]
            for reply in await self._ha.gather_ring(
                    "GetTask", {"task_id": payload["task_id"]}):
                if reply:
                    lists.append(reply.get("attempts"))
            attempts = sorted(merge_public_records(lists),
                              key=lambda r: r["attempt"])
        if not attempts:
            return None
        return {"task_id": payload["task_id"], "attempts": attempts,
                "stats": self._state_stats()}

    async def _summarize_tasks(self, payload):
        payload = payload or {}
        filters = {k: payload.get(k) for k in ("job_id", "node_id")}
        if self._ha is not None and not payload.get("local_only"):
            from ant_ray_tpu_torch._private.task_state import (  # noqa: PLC0415
                summarize_public_records,
            )

            records, dropped, events_dropped = \
                await self._merged_task_records(filters)
            reply = summarize_public_records(records)
            reply["num_tasks_dropped"] = dropped
            reply["task_events_dropped"] = events_dropped
            return reply
        reply = self._task_state.summarize(filters=filters)
        reply["task_events_dropped"] = self._task_events_dropped
        return reply

    async def _list_jobs(self, _payload):
        return [
            {"job_id": job_id.hex(),
             "driver_address": info.get("driver_address", ""),
             "started_at": info.get("started_at")}
            for job_id, info in self._jobs.items()
        ]

    # ------------------------------------------------------ step events
    # (observability/step_profiler.py: batch-published per-step phase
    #  records, one bounded ring like task events)

    async def _step_events_add(self, payload):
        self._step_events.extend(payload.get("records", ()))
        return True

    async def _step_events_get(self, payload):
        payload = payload or {}
        limit = int(payload.get("limit", 20000))
        rank = payload.get("rank")
        records = list(self._step_events)
        if rank is not None:
            records = [r for r in records if r.get("rank") == rank]
        if self._ha is not None and not payload.get("local_only"):
            for peer_records in await self._ha.gather_ring(
                    "StepEventsGet", payload):
                records.extend(peer_records)
            records.sort(key=lambda r: r.get("ts") or 0.0)
        return records[-limit:]

    # ------------------------------------------------------ span events
    # (observability/tracing_plane.py: per-process flight recorders
    #  batch-publish sampled + force-sampled spans here; one bounded
    #  ring like step events)

    async def _span_events_add(self, payload):
        self._span_events.extend(payload.get("spans", ()))
        return True

    async def _span_events_get(self, payload):
        payload = payload or {}
        limit = int(payload.get("limit", 50000))
        trace_id = payload.get("trace_id")
        node_id = payload.get("node_id")
        errors_only = payload.get("errors_only")
        spans = list(self._span_events)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        if node_id:
            spans = [s for s in spans
                     if str(s.get("node_id", "")).startswith(node_id)]
        if errors_only:
            spans = [s for s in spans if s.get("error")]
        if self._ha is not None and not payload.get("local_only"):
            for peer_spans in await self._ha.gather_ring(
                    "SpanEventsGet", payload):
                spans.extend(peer_spans)
            spans.sort(key=lambda s: s.get("ts") or 0.0)
        return spans[-limit:]

    # ---------------------------------------------------- cpu profiles
    # (observability/cpu_profiler.py: every process class publishes its
    #  folded-stack delta each publish period; one bounded ring like
    #  step/span events, sharded under HA and merged at query time)

    async def _cpu_profile_add(self, payload):
        self._cpu_profile.extend(payload.get("records", ()))
        return True

    async def _cpu_profile_get(self, payload):
        payload = payload or {}
        limit = int(payload.get("limit", 4000))
        node_id = payload.get("node_id")
        proc = payload.get("proc")
        since_ts = payload.get("since_ts")
        records = list(self._cpu_profile)
        if node_id:
            records = [r for r in records
                       if str(r.get("node_id", "")).startswith(node_id)]
        if proc:
            records = [r for r in records if r.get("proc") == proc]
        if since_ts is not None:
            records = [r for r in records
                       if (r.get("ts") or 0.0) >= float(since_ts)]
        if self._ha is not None and not payload.get("local_only"):
            for peer_records in await self._ha.gather_ring(
                    "CpuProfileGet", payload):
                records.extend(peer_records)
            records.sort(key=lambda r: r.get("ts") or 0.0)
        return records[-limit:]

    # -------------------------------------------------------- metrics
    # (ref: src/ray/stats/metric.h registry + the dashboard metrics
    #  agent python/ray/_private/metrics_agent.py — GCS holds the
    #  aggregated series; the dashboard renders Prometheus text)

    async def _metric_record(self, payload):
        """{"name","type","value","tags","description"} — counters
        accumulate, gauges overwrite, histograms keep running stats."""
        key = (payload["name"],
               tuple(sorted((payload.get("tags") or {}).items())))
        mtype = payload["type"]
        entry = self._metrics.get(key)
        if entry is None:
            entry = {"name": payload["name"], "type": mtype,
                     "tags": dict(payload.get("tags") or {}),
                     "description": payload.get("description", ""),
                     "value": 0.0, "count": 0, "sum": 0.0}
            self._metrics[key] = entry
        value = float(payload["value"])
        if mtype == "counter":
            entry["value"] += value
        elif mtype == "gauge":
            entry["value"] = value
        else:  # histogram: running count/sum + per-bucket tallies
            bounds = payload.get("boundaries")
            if bounds and "boundaries" not in entry:
                entry["boundaries"] = [float(b) for b in bounds]
                entry["buckets"] = [0] * len(entry["boundaries"])
            entry["count"] += 1
            entry["sum"] += value
            entry["value"] = value
            for i, le in enumerate(entry.get("boundaries", ())):
                if value <= le:
                    entry["buckets"][i] += 1
                    break               # cumulation happens at render
            # OpenMetrics exemplar: keep the latest per series — the
            # /metrics renderer links the histogram to a concrete
            # trace id (tracing_plane's rpc histograms send these).
            if payload.get("exemplar"):
                entry["exemplar"] = payload["exemplar"]
        self._metrics_dirty = True
        return True

    async def _metrics_get(self, _payload):
        return list(self._metrics.values())

    async def _metrics_expire(self, payload):
        """Drop series whose tags match ``match_tags`` (all pairs must
        match; ``name_prefix`` additionally narrows by metric name).
        The owners of per-entity gauges call this at teardown — a dead
        node's ``art_device_hbm_*`` or a removed replica's
        ``art_serve_breaker_state`` must not live in /metrics forever."""
        match = dict(payload.get("match_tags") or {})
        prefix = payload.get("name_prefix", "")
        if not match and not prefix:
            return 0
        doomed = [key for key, entry in self._metrics.items()
                  if (not prefix or entry["name"].startswith(prefix))
                  and all(entry["tags"].get(k) == v
                          for k, v in match.items())]
        for key in doomed:
            del self._metrics[key]
        if doomed:
            self._metrics_dirty = True
        return len(doomed)

    def _expire_node_metrics(self, node_id: NodeID) -> None:
        """Node-death hook: series tagged with the dead node's id (the
        agent's ``art_device_hbm_*`` publishes, any per-node gauges
        recorded into the table) are pruned immediately."""
        full, short = node_id.hex(), node_id.hex()[:12]
        doomed = [key for key, entry in self._metrics.items()
                  if entry["tags"].get("node_id") in (full, short)]
        for key in doomed:
            del self._metrics[key]
        if doomed:
            self._metrics_dirty = True

    # ------------------------------------------------------------- kv

    async def _kv_put(self, payload):
        key, value = payload["key"], payload["value"]
        overwrite = payload.get("overwrite", True)
        if not overwrite and key in self._kv:
            return False
        self._kv[key] = value
        self._persist("kv", key, value)
        return True

    async def _kv_get(self, payload):
        import pickle  # noqa: PLC0415

        key = payload["key"]
        value = self._kv.get(key)
        if self._ha is None or self._ha.is_leader_active():
            return value
        if payload.get("fence"):
            # Authoritative read-your-writes: ask the LEADER's
            # in-memory table.  Correct on every store backend — a
            # remote store's write-through is async (ack precedes
            # landing), so even a fenced store read could miss the
            # leader's latest acknowledged put; and the store, not the
            # synced cache, decides deletes (a deleted key must not
            # resurrect from sync lag).
            leader = self._ha.leader_addr()
            if leader:
                try:
                    return await self._clients.get(leader).call_async(
                        "KVGet", {"key": key}, timeout=5)
                except Exception:  # noqa: BLE001 — leader mid-death:
                    pass           # fall back to the fenced store read
            blob = await asyncio.to_thread(self._store.get, "kv", key)
            return pickle.loads(blob) if blob is not None else None
        if value is None:
            # Plain cache miss: best-effort freshness via the store (a
            # just-put key beats the sync period; a fence failure
            # raises typed StoreFenceError instead of serving stale).
            blob = await asyncio.to_thread(self._store.get, "kv", key)
            if blob is not None:
                value = pickle.loads(blob)
        return value

    async def _kv_del(self, payload):
        self._persist_del("kv", payload["key"])
        return self._kv.pop(payload["key"], None) is not None

    async def _kv_take(self, payload):
        """Atomic get-and-delete (one event-loop turn — no reader can
        interleave between the read and the removal).  The p2p mailbox
        protocol (xla_group.py send/recv) relies on this to make
        exactly one of {receiver-take, sender-withdraw} win."""
        value = self._kv.pop(payload["key"], None)
        if value is not None:
            self._persist_del("kv", payload["key"])
        return value

    async def _kv_keys(self, payload):
        prefix = payload.get("prefix", "")
        return [k for k in self._kv if k.startswith(prefix)]

    # ------------------------------------------------------------- jobs

    async def _register_job(self, payload):
        self._jobs[payload["job_id"]] = {
            "driver_address": payload.get("driver_address", ""),
            "started_at": time.time(),
        }
        self._persist("jobs", payload["job_id"].hex(),
                      (payload["job_id"], self._jobs[payload["job_id"]]))
        if self._exporter is not None:
            self._exporter.record("EXPORT_DRIVER_JOB", "STARTED",
                                  payload["job_id"],
                                  self._jobs[payload["job_id"]])
        return True

    # ------------------------------------------------------------- actors

    async def _create_actor(self, spec: ActorSpec):
        key = (spec.namespace, spec.name)
        if spec.name:
            existing_id = self._named_actors.get(key)
            if existing_id is not None:
                existing = self._actors.get(existing_id)
                if existing is not None and existing.state != ACTOR_DEAD:
                    return {"error": f"actor name {spec.name!r} already taken",
                            "existing_actor_id": existing_id}
        record = ActorRecord(spec=spec)
        self._actors[spec.actor_id] = record
        if spec.name:
            self._named_actors[key] = spec.actor_id
        self._save_actor(record)
        _spawn(self._schedule_actor(record))
        return {"ok": True}

    async def _schedule_actor(self, record: ActorRecord):
        try:
            await self._schedule_actor_inner(record)
        except Exception as e:  # noqa: BLE001 — never leave PENDING forever
            logger.exception("actor scheduling failed")
            record.state = ACTOR_DEAD
            record.death_reason = f"scheduling error: {e}"
            record.state_event.set()
            self._save_actor(record)

    async def _schedule_actor_inner(self, record: ActorRecord):
        spec = record.spec
        placement = spec.placement_resources or spec.resources
        start = time.monotonic()
        while True:
            # 30s without a feasible node kills the actor — unless an
            # autoscaler is alive, in which case the recorded demand may
            # provision one (give it the reference's 10-minute window).
            limit = 600.0 if self._has_live_autoscaler() else 30.0
            if time.monotonic() - start > limit:
                break
            strategy = getattr(spec, "scheduling_strategy", None)
            if spec.placement_group_id is not None:
                node = self._pg_bundle_node(
                    spec.placement_group_id,
                    spec.placement_group_bundle_index)
            elif strategy == "SPREAD":
                node = self._pick_node_spread(
                    placement,
                    self._allowed_nodes_for_job(spec.job_id),
                    spec.label_selector)
            elif isinstance(strategy, dict) and \
                    strategy.get("kind") == "node_affinity":
                # The pin must still respect every fence the other
                # placement paths enforce: virtual-cluster membership,
                # label selector, and capacity feasibility.
                allowed = self._allowed_nodes_for_job(spec.job_id)
                node = next(
                    (n for n in self._feasible_nodes(
                        placement, False, allowed, spec.label_selector)
                     if n.node_id.hex() == strategy["node_id"]), None)
                if node is None and not strategy.get("soft"):
                    record.state = ACTOR_DEAD
                    record.death_reason = (
                        "node-affinity target "
                        f"{strategy['node_id'][:12]} is not alive, not "
                        "in the job's virtual cluster, or cannot "
                        "satisfy the actor's demand")
                    record.state_event.set()
                    self._save_actor(record)
                    return
                if node is None:       # soft: fall back to DEFAULT
                    node = self._pick_node(
                        placement,
                        allowed=allowed,
                        label_selector=spec.label_selector)
            else:
                node = self._pick_node(
                    placement,
                    allowed=self._allowed_nodes_for_job(spec.job_id),
                    label_selector=spec.label_selector)
            if node is not None:
                record.node_id = node.node_id
                client = self._clients.get(node.address)
                try:
                    await client.call_async("StartActorWorker", spec,
                                            timeout=30)
                    return  # worker will report ALIVE via ActorStateUpdate
                except Exception as e:  # noqa: BLE001 — reschedule
                    logger.warning("actor %s placement on %s failed: %s",
                                   spec.actor_id.hex()[:8],
                                   node.node_id.hex()[:8], e)
            elif spec.placement_group_id is None:
                # Unplaceable actor: surface the shape to the autoscaler.
                self._record_demand(placement, spec.label_selector)
            await asyncio.sleep(0.5)
        record.state = ACTOR_DEAD
        record.death_reason = "no node with required resources"
        record.state_event.set()
        self._save_actor(record)

    @staticmethod
    def _labels_match(info: NodeInfo, selector: dict | None) -> bool:
        """Exact-match label selector (ref: LabelSelector,
        src/ray/common/scheduling/label_selector.h — equality terms)."""
        if not selector:
            return True
        return all(info.labels.get(k) == v for k, v in selector.items())

    def _init_sched_observatory(self) -> None:
        """Scheduler-scope observatory state.  Called from __init__,
        and lazily from _pick_node so scheduling-policy unit tests can
        exercise a bare ``object.__new__(GcsServer)`` with just
        ``_nodes`` populated."""
        # Scheduler scan width: how many node records each feasibility
        # scan walked — THE number that says lease cost is O(nodes).
        self._sched_stats = {"scans": 0, "scanned_nodes": 0,
                             "picks": 0, "pick_cache_hits": 0}
        # Sticky pack-pick cache: (resources, by_available) -> node_id
        # of the last grant target, re-VALIDATED against live state
        # before reuse (never trusted stale) — see _pick_node.
        self._pick_cache: dict[tuple, NodeID] = {}

    def _feasible_nodes(self, resources: dict[str, float],
                        by_available: bool,
                        allowed: set | None,
                        label_selector: dict | None) -> list[NodeInfo]:
        out = []
        self._sched_stats["scans"] += 1
        self._sched_stats["scanned_nodes"] += len(self._nodes)
        for info in self._nodes.values():
            if self._node_feasible(info, resources, by_available,
                                   allowed, label_selector):
                out.append(info)
        return out

    def _node_feasible(self, info: NodeInfo,
                       resources: dict[str, float],
                       by_available: bool,
                       allowed: set | None,
                       label_selector: dict | None) -> bool:
        """The per-node grantability predicate — one place, shared by
        the full feasibility scan and the pick-cache revalidation."""
        if not info.alive:
            return False
        if getattr(info, "disk_full", False):
            return False  # out-of-disk nodes take no new work
        if getattr(info, "draining", False):
            return False  # announced departures take no new work
        if allowed is not None and info.node_id not in allowed:
            return False
        if not self._labels_match(info, label_selector):
            return False
        view = (info.available_resources if by_available
                else info.total_resources)
        return all(view.get(k, 0.0) >= v for k, v in resources.items())

    @staticmethod
    def _utilization(info: NodeInfo) -> float:
        total = sum(info.total_resources.values()) or 1.0
        free = sum(info.available_resources.values())
        return 1.0 - free / total

    def _pick_node(self, resources: dict[str, float],
                   by_available: bool = True,
                   allowed: set | None = None,
                   label_selector: dict | None = None) -> NodeInfo | None:
        """Hybrid pack/spread policy (ref:
        src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h —
        the reference's DEFAULT): prefer the BUSIEST feasible node
        whose utilization stays under the threshold (packing keeps
        small tasks off idle accelerator nodes and lets the autoscaler
        drain them), and once every candidate is past the threshold,
        spread to the least-utilized.

        by_available=True matches against the (heartbeat-fed, possibly
        stale) availability view; by_available=False against total
        capacity — used to distinguish "busy right now" from "can never
        run" (ref: ClusterResourceScheduler feasibility vs availability).
        ``allowed`` restricts candidates (virtual-cluster membership);
        ``label_selector`` restricts to nodes advertising those labels
        (TPU generation / pod / worker-id).

        Scale fix (measured by benchmarks/scale_harness.py — the worst
        cliff at N=500 was O(nodes) feasibility scans per lease): the
        last pick per plain scheduling shape is cached and REVALIDATED
        against live state before reuse.  Packing semantics make the
        sticky pick natural — consecutive leases WANT the same busiest
        under-threshold node, and the GCS availability view only moves
        on heartbeats anyway, so a fresh scan in between returns the
        same node at O(nodes) cost.  The cache never serves a dead,
        draining, full, or over-threshold node (the revalidation is the
        same predicate the scan uses on that one node); shapes with a
        virtual-cluster or label restriction always take the full scan.
        Config-gated (``sched_pick_cache``) so the harness can measure
        the before/after curve.
        """
        try:
            self._sched_stats["picks"] += 1
        except AttributeError:  # bare unit-test construction
            self._init_sched_observatory()
            self._sched_stats["picks"] += 1
        cfg = global_config()
        threshold = cfg.hybrid_pack_threshold
        cache_key = None
        if cfg.sched_pick_cache and allowed is None \
                and not label_selector:
            cache_key = (tuple(sorted(resources.items())), by_available)
            cached_id = self._pick_cache.get(cache_key)
            if cached_id is not None:
                info = self._nodes.get(cached_id)
                if info is not None \
                        and self._node_feasible(info, resources,
                                                by_available, None, None) \
                        and self._utilization(info) <= threshold:
                    self._sched_stats["pick_cache_hits"] += 1
                    return info
                self._pick_cache.pop(cache_key, None)
        candidates = self._feasible_nodes(resources, by_available,
                                          allowed, label_selector)
        if not candidates:
            return None
        under = [n for n in candidates
                 if self._utilization(n) <= threshold]
        if under:
            # Pack: busiest first; node id tie-break for determinism.
            pick = max(under, key=lambda n: (self._utilization(n),
                                             n.node_id.hex()))
            if cache_key is not None:
                if len(self._pick_cache) >= 64:  # bounded: shapes churn
                    self._pick_cache.clear()
                self._pick_cache[cache_key] = pick.node_id
            return pick
        # All hot: spread to the least-utilized.
        return min(candidates, key=lambda n: (self._utilization(n),
                                              n.node_id.hex()))

    def _pick_node_spread(self, resources, allowed, label_selector,
                          exclude=None) -> NodeInfo | None:
        """SPREAD policy: round-robin over feasible nodes (ref:
        spread_scheduling_policy.h).  ``exclude`` drops the saturated
        requester (it asked to spill AWAY) unless it is the only
        candidate."""
        candidates = self._feasible_nodes(resources, True, allowed,
                                          label_selector)
        if not candidates:
            candidates = self._feasible_nodes(resources, False, allowed,
                                              label_selector)
        if exclude is not None and len(candidates) > 1:
            candidates = [n for n in candidates
                          if n.node_id != exclude]
        if not candidates:
            return None
        candidates.sort(key=lambda n: n.node_id.hex())
        self._spread_rr += 1
        return candidates[self._spread_rr % len(candidates)]

    def _pg_bundle_node(self, pg_id, bundle_index: int) -> NodeInfo | None:
        record = self._placement_groups.get(pg_id)
        if record is None or record["state"] != "CREATED":
            return None
        if not 0 <= bundle_index < len(record["bundle_nodes"]):
            raise ValueError(
                f"bundle index {bundle_index} out of range for group with "
                f"{len(record['bundle_nodes'])} bundles")
        return record["bundle_nodes"][bundle_index]

    async def _actor_state_update(self, payload):
        actor_id = payload["actor_id"]
        record = self._actors.get(actor_id)
        if record is None:
            return False
        record.state = payload["state"]
        record.address = payload.get("address", record.address)
        if payload.get("node_id") is not None:
            record.node_id = payload["node_id"]
        if record.state == ACTOR_DEAD:
            record.death_reason = payload.get("reason", "")
        record.state_event.set()
        record.state_event = asyncio.Event()
        self._save_actor(record)
        self._publish("actor_state", {
            "actor_id": record.spec.actor_id, "state": record.state,
            "address": record.address,
            "death_reason": record.death_reason})
        return True

    async def _list_actors(self, _payload):
        return [
            {
                "actor_id": r.spec.actor_id.hex(),
                "class_name": r.spec.class_name,
                "state": r.state,
                "address": r.address,
                "name": r.spec.name,
                # Where the actor runs (drain-plane consumers map
                # replicas/gang workers to draining nodes with this).
                "node_id": (r.node_id.hex()
                            if r.node_id is not None else None),
                "job_id": (r.spec.job_id.hex()
                           if r.spec.job_id is not None else None),
                "death_reason": r.death_reason,
            }
            for r in self._actors.values()
        ]

    async def _list_objects(self, _payload):
        return [
            {
                "object_id": oid.hex(),
                "locations": [nid.hex() for nid in nodes],
                "owner": self._object_meta.get(oid, {}).get("owner"),
                "callsite": self._object_meta.get(oid, {}).get(
                    "callsite"),
            }
            for oid, nodes in self._object_locations.items()
        ]

    async def _get_actor_info(self, payload):
        record = self._actors.get(payload["actor_id"])
        if record is None:
            return None
        return self._actor_info(record)

    def _actor_info(self, record: ActorRecord) -> dict:
        return {
            "actor_id": record.spec.actor_id,
            "state": record.state,
            "address": record.address,
            "node_id": record.node_id,
            "class_name": record.spec.class_name,
            "death_reason": record.death_reason,
            "name": record.spec.name,
        }

    async def _wait_actor_alive(self, payload):
        record = self._actors.get(payload["actor_id"])
        if record is None:
            return None
        deadline = time.monotonic() + payload.get("timeout", 30.0)
        while record.state not in (ACTOR_ALIVE, ACTOR_DEAD):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            event = record.state_event
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                break
        return self._actor_info(record)

    async def _get_named_actor(self, payload):
        key = (payload.get("namespace", "default"), payload["name"])
        actor_id = self._named_actors.get(key)
        if actor_id is None:
            return None
        record = self._actors.get(actor_id)
        if record is None or record.state == ACTOR_DEAD:
            return None
        return self._actor_info(record)

    async def _kill_actor(self, payload):
        record = self._actors.get(payload["actor_id"])
        if record is None:
            return False
        no_restart = payload.get("no_restart", True)
        restartable = (not no_restart
                       and record.restarts_used < record.spec.max_restarts)
        if no_restart:
            record.spec.max_restarts = 0
        if record.node_id is not None:
            node = self._nodes.get(record.node_id)
            if node is not None and node.alive:
                client = self._clients.get(node.address)
                try:
                    await client.call_async(
                        "KillActorWorker",
                        {"actor_id": record.spec.actor_id}, timeout=10)
                except Exception:  # noqa: BLE001 — worker may be gone already
                    pass
        if restartable:
            # kill(no_restart=False): the worker death is a restartable
            # failure — the daemon's WorkerDied report (or this direct
            # call) drives the normal restart machinery, and subscribers
            # see RESTARTING, never a terminal DEAD.
            await self._handle_actor_failure(record,
                                             "killed via kill(no_restart"
                                             "=False)")
            return True
        record.state = ACTOR_DEAD
        record.death_reason = "killed via kill()"
        record.state_event.set()
        self._save_actor(record)
        self._publish("actor_state", {
            "actor_id": record.spec.actor_id, "state": ACTOR_DEAD,
            "address": "", "death_reason": record.death_reason})
        return True

    async def _worker_died(self, payload):
        if self._exporter is not None:
            self._exporter.record("EXPORT_WORKER", "DIED",
                                  payload.get("worker_id"), payload)
        actor_id = payload.get("actor_id")
        if actor_id is not None:
            record = self._actors.get(actor_id)
            if record is not None and record.state != ACTOR_DEAD:
                await self._handle_actor_failure(
                    record, payload.get("reason", "worker died"))
        return True

    async def _handle_actor_failure(self, record: ActorRecord, reason: str):
        if record.restarts_used < record.spec.max_restarts:
            record.restarts_used += 1
            record.state = ACTOR_RESTARTING
            record.address = ""
            record.state_event.set()
            record.state_event = asyncio.Event()
            logger.info("restarting actor %s (%d/%d): %s",
                        record.spec.actor_id.hex()[:8], record.restarts_used,
                        record.spec.max_restarts, reason)
            self._save_actor(record)
            self._publish("actor_state", {
                "actor_id": record.spec.actor_id,
                "state": ACTOR_RESTARTING, "address": "",
                "death_reason": ""})
            _spawn(self._schedule_actor(record))
        else:
            record.state = ACTOR_DEAD
            record.death_reason = reason
            record.state_event.set()
            record.state_event = asyncio.Event()
            self._save_actor(record)
            self._publish("actor_state", {
                "actor_id": record.spec.actor_id, "state": ACTOR_DEAD,
                "address": "", "death_reason": reason})

    # ------------------------------------------------------------- objects

    async def _object_location_add(self, payload):
        oid = payload["object_id"]
        self._object_locations.setdefault(oid, set()).add(
            payload["node_id"])
        # Optional attribution sidecar (additive payload keys): the
        # SEALING daemon knows the producer — pull-replica adds don't
        # resend it, so only fill what's missing.
        owner = payload.get("owner")
        if owner:
            meta = self._object_meta.setdefault(oid, {})
            meta.setdefault("owner", owner)
            if payload.get("callsite"):
                meta.setdefault("callsite", payload["callsite"])
        self._save_locations(oid)
        return True

    async def _object_location_remove(self, payload):
        oid = payload["object_id"]
        locs = self._object_locations.get(oid)
        if locs is not None:
            locs.discard(payload["node_id"])
            if not locs:
                del self._object_locations[oid]
                self._object_meta.pop(oid, None)
        self._save_locations(oid)
        return True

    async def _object_locations_get(self, payload):
        node_ids = self._object_locations.get(payload["object_id"], set())
        return [self._nodes[nid] for nid in node_ids
                if nid in self._nodes and self._nodes[nid].alive]

    async def _free_object(self, payload):
        oid = payload["object_id"]
        node_ids = self._object_locations.pop(oid, set())
        self._object_meta.pop(oid, None)
        self._save_locations(oid)
        for nid in node_ids:
            node = self._nodes.get(nid)
            if node is None or not node.alive:
                continue
            client = self._clients.get(node.address)
            try:
                await client.oneway_async("DeleteObject", {"object_id": oid})
            except Exception:  # noqa: BLE001
                pass
        return True

    # ------------------------------------------------- placement groups
    # (ref: GcsPlacementGroupManager + 2-phase bundle reservation,
    #  gcs_placement_group_scheduler.h)

    async def _create_placement_group(self, payload):
        record = {
            "pg_id": payload["pg_id"],
            "bundles": payload["bundles"],
            "strategy": payload["strategy"],
            "name": payload.get("name", ""),
            "job_id": payload.get("job_id"),
            "state": "PENDING",
            "bundle_nodes": [None] * len(payload["bundles"]),
            "reason": "",
            "bundle_selectors": payload.get("bundle_label_selectors"),
            "same_label": payload.get("same_label"),
            "same_label_groups": payload.get("same_label_groups"),
        }
        self._placement_groups[payload["pg_id"]] = record
        self._save_pg(record)
        if self._exporter is not None:
            self._exporter.record(
                "EXPORT_PLACEMENT_GROUP", "PENDING", payload["pg_id"],
                {"strategy": record["strategy"], "name": record["name"],
                 "bundles": record["bundles"]})
        _spawn(self._schedule_placement_group(record))
        return True

    def _plan_bundles(self, bundles, strategy, job_id=None,
                      bundle_selectors=None,
                      same_label=None,
                      same_label_groups=None) -> list[NodeInfo] | None:
        """Choose a node per bundle against the availability view; None if
        no valid assignment right now.  Candidates respect the job's
        virtual cluster.

        ``bundle_selectors``: optional per-bundle label selectors (exact
        match).  ``same_label``: a label key whose VALUE must be shared by
        every chosen node — the slice-affinity constraint ("all bundles on
        one gpu-pod-name") behind util/gpu.py SlicePlacementGroup (ref:
        python/ray/util/tpu.py:52, bundle_label_selector).
        ``same_label_groups``: lists of bundle indices, each group pinned
        to ONE value of ``same_label`` and distinct groups to DISTINCT
        values — the multi-slice gang constraint (each slice's ranks
        co-located on one pod, different slices on different pods)."""
        allowed = self._allowed_nodes_for_job(job_id)
        alive = [n for n in self._nodes.values()
                 if n.alive and not getattr(n, "draining", False)
                 and (allowed is None or n.node_id in allowed)]
        if same_label is not None and same_label_groups:
            # Groups claim disjoint label values, so their node pools are
            # disjoint — planning them sequentially with independent
            # resource views is exact, not an approximation.  Greedy
            # first-fit value choice per group (deterministic order so
            # repeated attempts converge).
            values = sorted({n.labels.get(same_label) for n in alive
                             if n.labels.get(same_label) is not None})
            plan_by_index: dict = {}
            used_values: set = set()
            for group in same_label_groups:
                sub_bundles = [bundles[i] for i in group]
                sub_selectors = ([bundle_selectors[i] for i in group]
                                 if bundle_selectors else None)
                placed = False
                for value in values:
                    if value in used_values:
                        continue
                    pool = [n for n in alive
                            if n.labels.get(same_label) == value]
                    plan = self._plan_bundles_in(
                        pool, sub_bundles, strategy, sub_selectors)
                    if plan is not None:
                        used_values.add(value)
                        for i, node in zip(group, plan):
                            plan_by_index[i] = node
                        placed = True
                        break
                if not placed:
                    return None
            # Bundles outside every group (none for multi-slice PGs, but
            # the contract allows it) plan unconstrained.
            rest = [i for i in range(len(bundles))
                    if i not in plan_by_index]
            if rest:
                rest_plan = self._plan_bundles_in(
                    alive, [bundles[i] for i in rest], strategy,
                    [bundle_selectors[i] for i in rest]
                    if bundle_selectors else None)
                if rest_plan is None:
                    return None
                for i, node in zip(rest, rest_plan):
                    plan_by_index[i] = node
            return [plan_by_index[i] for i in range(len(bundles))]
        if same_label is not None:
            # Try each value-group of the shared label independently;
            # first group that fits wins.  Deterministic order so
            # repeated attempts converge.
            values = sorted({n.labels.get(same_label) for n in alive
                             if n.labels.get(same_label) is not None})
            for value in values:
                group = [n for n in alive
                         if n.labels.get(same_label) == value]
                plan = self._plan_bundles_in(
                    group, bundles, strategy, bundle_selectors)
                if plan is not None:
                    return plan
            return None
        return self._plan_bundles_in(alive, bundles, strategy,
                                     bundle_selectors)

    def _plan_bundles_in(self, alive, bundles, strategy,
                         bundle_selectors=None) -> list[NodeInfo] | None:
        remaining = {n.node_id: dict(n.available_resources) for n in alive}

        def selector_ok(node, index):
            if not bundle_selectors:
                return True
            return self._labels_match(node, bundle_selectors[index])

        def fits(node_id, bundle):
            return all(remaining[node_id].get(k, 0.0) >= v
                       for k, v in bundle.items())

        def take(node_id, bundle):
            for k, v in bundle.items():
                remaining[node_id][k] = remaining[node_id].get(k, 0.0) - v

        plan: list[NodeInfo] = []
        if strategy in ("STRICT_PACK", "PACK"):
            # try to fit everything on one node
            for node in alive:
                if not all(selector_ok(node, i)
                           for i in range(len(bundles))):
                    continue
                snapshot = dict(remaining[node.node_id])
                ok = True
                for bundle in bundles:
                    if fits(node.node_id, bundle):
                        take(node.node_id, bundle)
                    else:
                        ok = False
                        break
                remaining[node.node_id] = snapshot
                if ok:
                    return [node] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
        # greedy per-bundle; SPREAD/STRICT_SPREAD prefer unused nodes
        used: set = set()
        for index, bundle in enumerate(bundles):
            candidates = sorted(
                alive, key=lambda n: (n.node_id in used,
                                      -sum(remaining[n.node_id].values())))
            chosen = None
            for node in candidates:
                if strategy == "STRICT_SPREAD" and node.node_id in used:
                    continue
                if not selector_ok(node, index):
                    continue
                if fits(node.node_id, bundle):
                    chosen = node
                    break
            if chosen is None:
                return None
            take(chosen.node_id, bundle)
            used.add(chosen.node_id)
            plan.append(chosen)
        return plan

    async def _schedule_placement_group(self, record):
        bundles = record["bundles"]
        deadline = time.monotonic() + 30.0
        while True:
            if time.monotonic() > deadline:
                # With a live autoscaler, provisioning (a GKE node pool
                # resize can take minutes) extends the wait — the gang
                # demand recorded below keeps driving it.
                if self._has_live_autoscaler():
                    deadline = time.monotonic() + \
                        global_config().infeasible_wait_s
                else:
                    break
            if record["state"] == "REMOVED":
                return
            plan = self._plan_bundles(
                bundles, record["strategy"], record.get("job_id"),
                bundle_selectors=record.get("bundle_selectors"),
                same_label=record.get("same_label"),
                same_label_groups=record.get("same_label_groups"))
            if plan is not None:
                prepared = []
                ok = True
                for index, (bundle, node) in enumerate(zip(bundles, plan)):
                    client = self._clients.get(node.address)
                    try:
                        reply = await client.call_async("PrepareBundle", {
                            "pg_id": record["pg_id"], "index": index,
                            "resources": bundle}, timeout=10)
                    except Exception:  # noqa: BLE001
                        reply = {"ok": False}
                    if reply.get("ok"):
                        prepared.append((index, node))
                    else:
                        ok = False
                        break
                # A concurrent RemovePlacementGroup may have fired while we
                # were preparing — or a node may die mid-commit.  Any such
                # case aborts and rolls back every prepared bundle.
                if ok and record["state"] != "REMOVED":
                    committed = True
                    for index, node in prepared:
                        client = self._clients.get(node.address)
                        try:
                            await client.call_async("CommitBundle", {
                                "pg_id": record["pg_id"], "index": index},
                                timeout=10)
                        except Exception:  # noqa: BLE001
                            committed = False
                            break
                        record["bundle_nodes"][index] = node
                    if committed and record["state"] != "REMOVED":
                        record["state"] = "CREATED"
                        self._drop_gang_demand(record)
                        self._save_pg(record)
                        return
                for index, node in prepared:  # roll back (2-phase abort)
                    record["bundle_nodes"][index] = None
                    client = self._clients.get(node.address)
                    try:
                        await client.call_async("ReturnBundle", {
                            "pg_id": record["pg_id"], "index": index},
                            timeout=10)
                    except Exception:  # noqa: BLE001
                        pass
                if record["state"] == "REMOVED":
                    return  # removal handler already dropped the store row
                self._save_pg(record)  # keep the store in sync w/ rollback
            else:
                # Unplaceable: surface the whole gang to the autoscaler
                # (a slice PG on an empty cluster is THE scale-up
                # trigger; without this the 120 retries starve silently).
                self._record_gang_demand(record)
                # Distinguish "busy now" from "never possible".
                totals = {n.node_id: dict(n.total_resources)
                          for n in self._nodes.values() if n.alive}
                feasible_nodes = len(totals)
                if record["strategy"] == "STRICT_SPREAD" and \
                        len(bundles) > feasible_nodes and \
                        not self._has_live_autoscaler():
                    record["state"] = "FAILED"
                    record["reason"] = (
                        f"STRICT_SPREAD needs {len(bundles)} nodes, "
                        f"cluster has {feasible_nodes}")
                    return
            await asyncio.sleep(0.25)
        record["state"] = "FAILED"
        record["reason"] = "timed out waiting for resources"

    async def _get_placement_group(self, payload):
        record = self._placement_groups.get(payload["pg_id"])
        if record is None:
            return None
        return {
            "state": record["state"],
            "strategy": record["strategy"],
            "reason": record["reason"],
            "bundle_nodes": [
                (n.address if n is not None else None)
                for n in record["bundle_nodes"]
            ],
            "bundles": record["bundles"],
        }

    async def _remove_placement_group(self, payload):
        record = self._placement_groups.get(payload["pg_id"])
        if record is None:
            return False
        record["state"] = "REMOVED"
        if self._exporter is not None:
            self._exporter.record("EXPORT_PLACEMENT_GROUP", "REMOVED",
                                  record["pg_id"], {})
        self._drop_gang_demand(record)
        # Persist the terminal state FIRST: a head crash mid-removal must
        # not resurrect a CREATED/PENDING record whose bundles the nodes
        # have already returned.
        self._persist_del("pgs", record["pg_id"].hex())
        for index, node in enumerate(record["bundle_nodes"]):
            if node is None:
                continue
            client = self._clients.get(node.address)
            try:
                await client.call_async("ReturnBundle", {
                    "pg_id": record["pg_id"], "index": index}, timeout=10)
            except Exception:  # noqa: BLE001
                pass
        del self._placement_groups[payload["pg_id"]]
        # Actors placed on the group die with it (ref: the reference's
        # remove_placement_group kills actors using the PG) — the
        # bundles' resources must actually come free, not stay held by
        # leases the dead reservation granted.  Kills run CONCURRENTLY:
        # a wedged node must not serialize the handler 10s per actor.
        doomed = [actor_rec for actor_rec in self._actors.values()
                  if actor_rec.state != ACTOR_DEAD
                  and actor_rec.spec.placement_group_id == payload["pg_id"]]

        async def _kill_quietly(actor_rec):
            try:
                await self._kill_actor({
                    "actor_id": actor_rec.spec.actor_id,
                    "no_restart": True})
            except Exception:  # noqa: BLE001 — actor already dying
                pass

        if doomed:
            await asyncio.gather(*[_kill_quietly(a) for a in doomed])
        return True

    async def _list_placement_groups(self, _payload):
        return {
            pg_id.hex(): {"state": r["state"], "strategy": r["strategy"],
                          "name": r["name"],
                          # hex, not the raw JobID — this reply feeds
                          # the dashboard's JSON endpoint directly
                          "job_id": (r["job_id"].hex()
                                     if r.get("job_id") is not None
                                     else None),
                          "bundles": r["bundles"]}
            for pg_id, r in self._placement_groups.items()
        }

    # ------------------------------------------------------------- placement

    async def _select_node(self, payload):
        resources = payload.get("resources", {})
        exclude = payload.get("exclude")
        selector = payload.get("label_selector")
        allowed = self._allowed_nodes_for_job(payload.get("job_id"))
        if payload.get("strategy") == "SPREAD":
            node = self._pick_node_spread(resources, allowed, selector,
                                          exclude=exclude)
            if node is None:
                self._record_demand(resources, selector)
            return node

        def _excluding(by_available: bool) -> NodeInfo | None:
            node = self._pick_node(resources, by_available, allowed,
                                   selector)
            if node is not None and node.node_id == exclude:
                others = [
                    n for n in self._nodes.values()
                    if n.alive and not getattr(n, "draining", False)
                    and n.node_id != exclude and (
                        allowed is None or n.node_id in allowed)
                    and self._labels_match(n, selector) and all(
                        (n.available_resources if by_available
                         else n.total_resources).get(k, 0) >= v
                        for k, v in resources.items())
                ]
                node = others[0] if others else None
            return node

        # Prefer a node that can run now; fall back to one that is merely
        # busy (the lease queues there) before declaring infeasibility.
        node = _excluding(True) or _excluding(False)
        if node is None:
            self._record_demand(resources, selector)
        return node

    # ---------------------------------------------- autoscaler surface
    # (ref: the v2 autoscaler's cluster-status input —
    # python/ray/autoscaler/v2/autoscaler.py:50; demand shapes come
    # from SelectNode misses the way the reference's come from the
    # resource-demand scheduler reports.)

    _DEMAND_TTL_S = 60.0

    def _record_demand(self, resources: dict, selector: dict | None):
        key = json.dumps([sorted(resources.items()),
                          sorted((selector or {}).items())])
        now = time.monotonic()
        entry = self._demands.get(key)
        if entry is None:
            # Prune here too — without an autoscaler polling
            # ResourceDemands, unique shapes would otherwise accumulate
            # in head memory for the cluster's lifetime.
            if len(self._demands) >= 256:
                self._prune_demands(now)
            if len(self._demands) >= 512:  # still full: drop the oldest
                oldest = min(self._demands,
                             key=lambda k: self._demands[k]["last_seen"])
                del self._demands[oldest]
            self._demands[key] = {
                "resources": dict(resources),
                "label_selector": dict(selector or {}),
                "count": 1, "first_seen": now, "last_seen": now}
        else:
            entry["count"] += 1
            entry["last_seen"] = now

    def _record_gang_demand(self, record) -> None:
        """An unplaceable placement group is a GANG demand: the
        autoscaler must provision a node set satisfying every bundle
        atomically (a whole TPU slice for slice PGs), not one bundle's
        worth of capacity (ref: gang resource requests in
        src/ray/gcs/gcs_autoscaler_state_manager.h — the cluster
        resource state reports pending gangs to the autoscaler).

        Keyed per PG — two pending identical-shape PGs are two gangs
        needing two node sets, so they must not merge into one demand
        entry.  The entry is dropped the moment the PG commits or is
        removed (_drop_gang_demand)."""
        selectors = record.get("bundle_selectors") or \
            [{} for _ in record["bundles"]]
        key = "gang:" + record["pg_id"].hex()
        now = time.monotonic()
        entry = self._demands.get(key)
        if entry is None:
            if len(self._demands) >= 256:
                self._prune_demands(now)
            if len(self._demands) >= 512:
                oldest = min(self._demands,
                             key=lambda k: self._demands[k]["last_seen"])
                del self._demands[oldest]
            self._demands[key] = {
                "pg_id": record["pg_id"].hex(),
                "bundles": [dict(b) for b in record["bundles"]],
                "bundle_selectors": [dict(s or {}) for s in selectors],
                "strategy": record["strategy"],
                "same_label": record.get("same_label"),
                "count": 1, "first_seen": now, "last_seen": now}
        else:
            entry["count"] += 1
            entry["last_seen"] = now

    def _drop_gang_demand(self, record) -> None:
        self._demands.pop("gang:" + record["pg_id"].hex(), None)

    def _prune_demands(self, now: float) -> None:
        for key in [k for k, e in self._demands.items()
                    if now - e["last_seen"] > self._DEMAND_TTL_S]:
            del self._demands[key]

    async def _resource_demands(self, _payload):
        now = time.monotonic()
        self._prune_demands(now)
        out = []
        for e in self._demands.values():
            common = {"count": e["count"],
                      "age_s": now - e["first_seen"],
                      "idle_s": now - e["last_seen"]}
            if "bundles" in e:
                out.append({"pg_id": e.get("pg_id"),
                            "bundles": e["bundles"],
                            "bundle_selectors": e["bundle_selectors"],
                            "strategy": e["strategy"],
                            "same_label": e["same_label"], **common})
            else:
                out.append({"resources": e["resources"],
                            "label_selector": e["label_selector"],
                            **common})
        return out

    async def _autoscaler_heartbeat(self, _payload):
        self._autoscaler_seen = time.monotonic()
        return True

    async def _autoscaling_enabled(self, _payload):
        return self._has_live_autoscaler()

    def _has_live_autoscaler(self) -> bool:
        return (self._autoscaler_seen is not None
                and time.monotonic() - self._autoscaler_seen < 30.0)

    async def _cluster_resources(self, _payload):
        totals: dict[str, float] = {}
        for info in self._nodes.values():
            # Draining nodes are excluded from BOTH capacity views: a
            # gang sized by totals that include an announced departure
            # would be unplaceable by the time it reserves.
            if info.alive and not getattr(info, "draining", False):
                for k, v in info.total_resources.items():
                    totals[k] = totals.get(k, 0.0) + v
        return totals

    async def _available_resources(self, _payload):
        totals: dict[str, float] = {}
        for info in self._nodes.values():
            # A draining node's capacity is unleaseable — reporting it
            # as available would make elastic policies size gangs the
            # scheduler can never place.
            if info.alive and not getattr(info, "draining", False):
                for k, v in info.available_resources.items():
                    totals[k] = totals.get(k, 0.0) + v
        return totals


def main():  # pragma: no cover — exercised via subprocess in tests
    import argparse
    import signal

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--monitor-pid", type=int, default=0,
                        help="exit when this process disappears")
    parser.add_argument("--store", default="",
                        help="sqlite path for durable tables (restart-"
                             "resync; empty = in-memory only)")
    parser.add_argument("--export-dir", default="",
                        help="directory for export-event JSONL files "
                             "(empty = export pipeline disabled)")
    parser.add_argument("--ha-replica-id", default="",
                        help="join the replicated control plane as this "
                             "replica (requires --store shared with the "
                             "other replicas); the lease decides the "
                             "leader, standbys serve follower reads")
    args = parser.parse_args()

    logging.basicConfig(
        level=global_config().log_level,
        format="[gcs %(levelname)s %(asctime)s] %(message)s")
    server = GcsServer(port=args.port, store_path=args.store or None,
                       export_dir=args.export_dir or None,
                       ha_replica_id=args.ha_replica_id or None)
    server.start()
    print(f"GCS_READY {server.address}", flush=True)

    stop = False

    def _term(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop:
        time.sleep(0.2)
        if args.monitor_pid and not os.path.exists(
                f"/proc/{args.monitor_pid}"):
            logger.warning("monitored pid %d gone; exiting", args.monitor_pid)
            break
    server.stop(graceful=False)
    # Skip interpreter teardown: daemon threads may hold the io loop and
    # sys.exit would wait on finalizers; the tables are flushed above.
    os._exit(0)


if __name__ == "__main__":
    main()
