"""Wire-schema registry: the versioned contract behind every RPC method
(ref: the reference's protobuf schemas, src/ray/protobuf/*.proto — here
the frames are pickled tuples ``(kind, seq, method, payload)``, so the
schema lives in this registry instead of .proto files, and the
connection-level version fence lives in protocol.PROTOCOL_VERSION).

Every method a server registers MUST have an entry here (enforced by
tests/test_wire_schema.py, which parses the registration blocks of the
service sources).  An entry records:

* ``service`` — which server exposes it,
* ``since``  — the protocol version that introduced it,
* ``payload`` / ``reply`` — one-line field contract.

Evolution rules (the versioning policy):

1. ADDING a method or an OPTIONAL payload key (readers use .get) is
   allowed within a protocol version — add the entry with the current
   ``since``.
2. REMOVING or RENAMING a method/field, or changing a field's meaning,
   requires bumping protocol.PROTOCOL_VERSION — mixed-version peers
   then fail fast at connect instead of mis-decoding frames.
3. Frame-shape changes (the tuple itself) always bump the version.
"""

from __future__ import annotations

V1 = 1


def _m(service: str, payload: str, reply: str, since: int = V1) -> dict:
    return {"service": service, "since": since,
            "payload": payload, "reply": reply}


METHODS: dict[str, dict] = {
    # ---- GCS (cluster head) -------------------------------------------
    "RegisterNode": _m("gcs", "NodeInfo", "bool"),
    "Heartbeat": _m("gcs", "{node_id, view_version?, view?}",
                    "{resync?, commands?}"),
    "GetAllNodes": _m("gcs", "{}", "{node_id: NodeInfo}"),
    "ListNodes": _m("gcs", "{limit?, token?, state?}",
                    "{nodes: [dict], next_token?, total, matched} "
                    "(server-side page + state filter; the ListTasks "
                    "cursor idiom over the node table)"),
    "GetScaleStats": _m("gcs", "{}",
                        "{table_rows, rings, subscribers, sched, "
                        "heartbeat, handle, io_loop_duty} (the scale "
                        "observatory's per-subsystem cost counters — "
                        "LOCAL introspection: any replica serves its "
                        "own process's view, so per-replica cost is "
                        "separable under HA)"),
    "DrainNode": _m("gcs", "{node_id, reason?, deadline?}",
                    "bool (node enters DRAINING: schedulers skip it, "
                    "Serve/Train migrate off it)"),
    "KVPut": _m("gcs", "{key, value, overwrite?}", "bool"),
    "KVGet": _m("gcs", "{key, fence?}",
                "bytes|None (fence: a follower answers through the "
                "shared store — read-your-writes across the HA split)"),
    "KVDel": _m("gcs", "{key}", "bool"),
    "KVTake": _m("gcs", "{key}", "bytes|None (atomic get+del)"),
    "KVKeys": _m("gcs", "{prefix}", "[key]"),
    "RegisterJob": _m("gcs", "{job_id, driver_address}", "bool"),
    "CreateActor": _m("gcs", "ActorSpec", "{actor_id|error}"),
    "GetActorInfo": _m("gcs", "{actor_id}", "{state, address, ...}"),
    "WaitActorAlive": _m("gcs", "{actor_id, timeout}",
                         "{state, address}"),
    "GetNamedActor": _m("gcs", "{name, namespace}", "{actor_id|None}"),
    "KillActor": _m("gcs", "{actor_id, no_restart}", "bool"),
    "ActorStateUpdate": _m("gcs", "{actor_id, state, address?, reason?}",
                           "bool"),
    "WorkerDied": _m("gcs", "{node_id, worker_id, actor_id?, reason}",
                     "bool"),
    "ObjectLocationAdd": _m("gcs", "{object_id, node_id, owner?, "
                                   "callsite?}", "bool"),
    "ObjectLocationRemove": _m("gcs", "{object_id, node_id}", "bool"),
    "ObjectLocationsGet": _m("gcs", "{object_id}", "[NodeInfo]"),
    "FreeObject": _m("gcs", "{object_id}", "bool (cluster-wide free)"),
    "SelectNode": _m("gcs",
                     "{resources, job_id?, label_selector?, strategy?, "
                     "exclude?}", "NodeInfo|None"),
    "ResourceDemands": _m("gcs", "{demands: [...]} (from daemons)",
                          "[{resources|bundles, count, ...}]"),
    "AutoscalerHeartbeat": _m("gcs", "{}", "bool"),
    "AutoscalingEnabled": _m("gcs", "{}", "bool"),
    "ClusterResources": _m("gcs", "{}", "{resource: total}"),
    "AvailableResources": _m("gcs", "{}", "{resource: available}"),
    "CreatePlacementGroup": _m(
        "gcs", "{pg_id, bundles, strategy, name?, job_id?, "
               "bundle_label_selectors?, same_label?}", "bool"),
    "GetPlacementGroup": _m("gcs", "{pg_id}", "record dict"),
    "RemovePlacementGroup": _m("gcs", "{pg_id}", "bool"),
    "ListPlacementGroups": _m("gcs", "{}", "[record]"),
    "ListActors": _m("gcs", "{}", "[{actor_id, state, ...}]"),
    "ListObjects": _m("gcs", "{}", "[{object_id, locations}]"),
    "MetricRecord": _m("gcs", "{name, tags, value, kind}", "bool"),
    "MetricsGet": _m("gcs", "{}", "[series]"),
    "CreateVirtualCluster": _m("gcs", "{vc_id, node_ids, divisible}",
                               "bool"),
    "RemoveVirtualCluster": _m("gcs", "{vc_id}", "bool"),
    "UpdateVirtualCluster": _m("gcs", "{vc_id, node_ids}", "bool"),
    "ListVirtualClusters": _m("gcs", "{}", "[vc record]"),
    "SetJobVirtualCluster": _m("gcs", "{job_id, vc_id|None}", "bool"),
    "GetJobVirtualCluster": _m("gcs", "{job_id}",
                               "{allowed: [node_id]|None}"),
    "InsightRecord": _m("gcs", "{events: [...]}", "bool"),
    "InsightGet": _m("gcs", "{limit?}", "[event]"),
    "TaskEventsAdd": _m("gcs", "{events: [{task_id, name, event, ...}], "
                               "dropped?}", "bool"),
    "TaskEventsGet": _m("gcs", "{limit?, task_id?, local_only?}",
                        "[event] (local_only: this replica's ring "
                        "slice only — the HA merge fan-out)"),
    "ListTasks": _m("gcs",
                    "{state?, name?, job_id?, actor_id?, node_id?, "
                    "limit?, token?, local_only?}",
                    "{tasks: [record], next_token?, num_tasks_dropped, "
                    "task_events_dropped} — served from the bounded "
                    "GCS state table with server-side filtering; the "
                    "client never pulls the raw event ring"),
    "GetTask": _m("gcs", "{task_id, local_only?}",
                  "{task_id, attempts: [record], stats}|None"),
    "SummarizeTasks": _m("gcs", "{job_id?, node_id?, local_only?}",
                         "{summary: {name: {state_counts, run_s: "
                         "{mean, p50, p99}}}, total_tasks, "
                         "num_tasks_dropped, task_events_dropped}"),
    "ListJobs": _m("gcs", "{}",
                   "[{job_id, driver_address, started_at}]"),
    "StepEventsAdd": _m("gcs", "{records: [{step, ts, total_s, phases, "
                               "mfu?, rank}]}", "bool"),
    "StepEventsGet": _m("gcs", "{limit?, rank?, local_only?}",
                        "[record]"),
    "SpanEventsAdd": _m("gcs", "{spans: [{trace_id, span_id, parent_id, "
                               "name, ts, dur_s, stages?, attrs?, "
                               "error?, node_id, pid}]}", "bool"),
    "SpanEventsGet": _m("gcs", "{limit?, trace_id?, node_id?, "
                               "errors_only?, local_only?}", "[span]"),
    "CpuProfileAdd": _m("gcs", "{records: [{node_id, pid, proc, ts, "
                               "dur_s, hz, samples, stacks: "
                               "{folded: count}}]}", "bool"),
    "CpuProfileGet": _m("gcs", "{limit?, node_id?, proc?, since_ts?, "
                               "local_only?}", "[record]"),
    "MetricsExpire": _m("gcs", "{match_tags?, name_prefix?}",
                        "int (series dropped; per-entity gauge owners "
                        "call this at teardown so dead nodes/replicas "
                        "don't live in /metrics forever)"),
    "GetHaView": _m("gcs", "{}",
                    "{ha, role, replica_id, address, leader, term, "
                    "last_failover_ts, replication_lag_s, replicas: "
                    "[{replica_id, address, role, lag_s, age_s}]} — "
                    "served by ANY replica (leader or standby); the "
                    "client router re-resolves the leader through it "
                    "after a failover"),
    "SubPoll": _m("gcs", "{channels, cursor, timeout}",
                  "{cursor, events: [(seq, channel, data)]}"),
    "PublishLogs": _m("gcs", "{node, entries: [{worker, pid, job_id?, "
                             "lines}]}", "bool"),
    "ExportEventsGet": _m("gcs", "{source_type?, limit?}",
                          "{enabled, events}"),
    "Shutdown": _m("gcs|node", "{}", "bool"),

    # ---- node daemon (raylet) -----------------------------------------
    "LeaseWorker": _m("node",
                      "{resources, job_id?, label_selector?, strategy?, "
                      "pg?, runtime_env?, deps?, routed?, count?}",
                      "{granted, worker_id, extra?: [{granted, "
                      "worker_id}]}|{spill}|{infeasible, reason} — "
                      "count asks for a batch of leases in one round "
                      "trip; extras come only from already-idle "
                      "capacity (both keys additive: old peers ignore "
                      "count / never send it)"),
    "ReturnWorker": _m("node", "{worker_id}", "bool"),
    "RegisterWorker": _m("node", "{worker_id, address, pid}",
                         "{ok}|{error}"),
    "StartActorWorker": _m("node", "{spec, pg?}", "{ok}|{infeasible}"),
    "KillActorWorker": _m("node", "{worker_id|actor_id}", "bool"),
    "WorkerBlocked": _m("node", "{worker_id}", "bool (cpu released)"),
    "WorkerUnblocked": _m("node", "{worker_id}", "bool"),
    "PrepareBundle": _m("node", "{pg_id, bundle_index, resources}",
                        "bool (2-phase commit phase 1)"),
    "CommitBundle": _m("node", "{pg_id, bundle_index}", "bool"),
    "ReturnBundle": _m("node", "{pg_id, bundle_index}", "bool"),
    "CreateBuffer": _m("node", "{object_id, size}",
                       "{path, offset} write grant"),
    "SealBuffer": _m("node", "{object_id}", "bool"),
    "SealObject": _m("node", "{object_id, data}", "bool"),
    "DeleteObject": _m("node", "{object_id}", "bool"),
    "ContainsObject": _m("node", "{object_id}", "bool"),
    "LocateObject": _m("node", "{object_id}",
                       "{size, ...}|None (transfer source probe)"),
    "ReadChunk": _m("node", "{object_id, offset, length}", "bytes"),
    "ReadChunkRaw": _m("node", "{object_id, offset, length, stripe?}",
                       "raw out-of-band frame: chunk bytes served "
                       "zero-copy (b'' past EOF, None when missing)"),
    "EnsureLocal": _m("node",
                      "{object_id, timeout, fail_fast_after?, pin_ttl?, "
                      "prefetch?}",
                      "{path, offset, size, pinned?, pin_token?}|"
                      "{no_holders}|{timeout}|{ok}"),
    "ReadDone": _m("node", "{object_id, pin_token}", "bool"),
    "RenewPins": _m("node", "{pins: [(oid, token)], ttl}", "{gone: []}"),
    "GetNodeInfo": _m("node", "{}", "NodeInfo"),
    "NotifyDrain": _m("node", "{reason?, deadline_s?}",
                      "bool (daemon self-drains + announces via "
                      "DrainNode; the operator/chaos drain surface)"),
    "DebugResources": _m("node", "{}",
                         "{available, bundles, workers} ledger dump"),
    "GetNodeMetrics": _m("node", "{}", "{gauges}"),
    "GetFlightRecorder": _m("node", "{limit?}",
                            "{node_id, spans} — this daemon process's "
                            "live flight-recorder ring (always on; "
                            "force-sampled error spans in their own "
                            "wrap-protected ring)"),
    "GetStoreStats": _m("node", "{}", "{used, capacity, spilled}"),
    "ListObjectStats": _m("node", "{}",
                          "{node_id, objects: [{object_id, size, "
                          "pins, sealed, tier, created_age_s, "
                          "chunk_cache_bytes}], store: {used, "
                          "capacity, spilled}} — per-object arena "
                          "detail behind `art memory` / /api/memory"),
    "GetSyncStats": _m("node", "{}", "{beats, views_sent, ...}"),
    "GetTransferStats": _m("node", "{include_read_log?}",
                           "{quota_waits, ..., read_log?}"),
    "ListLogs": _m("node", "{}", "[{filename, size}]"),
    "ReadLog": _m("node", "{filename, offset?, tail?, max_bytes?}",
                  "{data, next_offset, eof}|{error}"),

    # ---- worker / owner (core runtime) --------------------------------
    "PushTask": _m("worker", "TaskSpec (fast route)",
                   "result payload — between hot-wire peers this "
                   "method rides HOT frames (hotframe.py: templated "
                   "zero-pickle calls, coalesced batched acks); the "
                   "pickled form stays the negotiation fallback"),
    "CancelTask": _m("worker", "{task_id}",
                     "bool — drop the task if it has not started "
                     "executing (oneway from owners; cooperative: "
                     "running tasks are never interrupted)"),
    "InstantiateActor": _m("worker", "ActorSpec", "bool"),
    "Ping": _m("worker|store", "{}", "'pong'"),
    "GetObject": _m("worker", "{object_id, timeout}",
                    "(kind, payload) owned-object fetch"),
    "GetObjectStatus": _m("worker", "{object_id}",
                          "'ready'|'pending'|'unknown'"),
    "GetObjectStatusBatch": _m("worker", "{object_ids: [oid]}",
                               "{oid: 'ready'|'pending'|'unknown'}"),
    "WaitObjects": _m("worker",
                      "{object_ids: [oid], num_ready?, timeout?}",
                      "{oid: status} — owner parks the reply until "
                      "num_ready listed refs are terminal or the "
                      "deadline fires (push-based wait)"),
    "GetObjectInfo": _m("worker", "{object_id}", "{status, size}"),
    "GetOwnedRefInfo": _m("worker", "{object_ids: [hex]}",
                          "{hex: {local_refs, borrows, pins}|None} — "
                          "owner-side refcounts for the memory-"
                          "attribution leak scan (None = the owner "
                          "holds no reference state for the id)"),
    "BorrowAdd": _m("worker", "{object_id}", "bool"),
    "BorrowRemove": _m("worker", "{object_id}", "bool"),
    "ReconstructObject": _m("worker", "{object_id}",
                            "bool (lineage re-execution)"),
    "StreamItem": _m("worker", "{task_id, index, payload|done}", "bool"),
    "DeviceTensorFetch": _m("worker", "{token}", "host tensor bytes"),
    "DeviceTensorFree": _m("worker", "{token}", "bool"),
    "DeviceTensorSendVia": _m("worker", "{token, group, dst_rank}",
                              "bool (shards pushed over the collective "
                              "group, mesh order)"),

    # ---- per-node agent (ref: agent_manager.h + runtime_env_agent) ----
    "BuildRuntimeEnv": _m("agent", "{wire}", "{ok}|{ok: False, error}"),
    "AgentListLogs": _m("agent", "{}", "[{filename, size}]"),
    "AgentReadLog": _m("agent", "{filename, offset?, tail?, max_bytes?}",
                       "{data, next_offset, eof}|{error}"),
    "AgentMetrics": _m("agent", "{}", "{os gauges}"),
    "AgentStats": _m("agent", "{}", "{env_builds, log_reads, "
                              "profiles_captured, device, ...}"),
    "AgentDeviceStats": _m("agent", "{}",
                           "[{name, type, value, tags, description}]"),
    "AgentProfile": _m("agent", "{duration_s?}",
                       "{trace_dir, archive, duration_s}|{error}"),
    "GetAgentInfo": _m("node", "{}", "{address, alive, restarts}"),

    # ---- store service (shared-store HA) ------------------------------
    "StorePut": _m("store", "{table, key, value}", "bool"),
    "StoreGet": _m("store", "{table, key}", "bytes|None"),
    "StoreDelete": _m("store", "{table, key}", "bool"),
    "StoreLoadTable": _m("store", "{table}", "{key: value}"),
    "LeaseAcquire": _m("store", "{name, owner, ttl}",
                       "bool (HA leader lease)"),
    "LeaseRenew": _m("store", "{name, owner, ttl}", "bool"),
    "LeaseRelease": _m("store", "{name, owner}", "bool"),
    "LeaseInfo": _m("store", "{name}", "{owner, expires_at}|None"),
}


# ---------------------------------------------------------------- HA split
#
# The replicated-GCS read/write classification (the HA analogue of the
# reference's GCS-FT blueprint): a GCS method is exactly one of
#
# * a FOLLOWER READ — servable by any replica from its store-synced
#   tables (staleness bounded by gcs_ha_sync_period_s); the client
#   router fans these out to standbys so read load scales with them;
# * a RING WRITE — a high-churn bounded-ring ingestion (task / step /
#   span events) accepted on ANY replica, sharded by producer key
#   client-side and merged at query time (the matching *Get / ListTasks
#   family accepts a ``local_only`` payload key for the merge fan-out);
# * everything else — a MUTATION, leader-only: a follower receiving one
#   replies with a typed NotLeaderError redirect.
#
# Follower-side enforcement and client-side routing both read THESE
# sets, so the split cannot drift between server and router.

GCS_FOLLOWER_READS = frozenset({
    "GetAllNodes", "ListNodes", "ClusterResources",
    "AvailableResources", "KVGet", "KVKeys",
    "ListActors", "ListObjects", "ListPlacementGroups",
    "ListVirtualClusters", "ListJobs",
    "MetricsGet", "InsightGet",
    "TaskEventsGet", "StepEventsGet", "SpanEventsGet",
    "CpuProfileGet", "GetScaleStats",
    "ListTasks", "GetTask", "SummarizeTasks",
    "GetHaView",
})

GCS_RING_WRITES = frozenset({
    "TaskEventsAdd", "StepEventsAdd", "SpanEventsAdd",
    "CpuProfileAdd",
})


def gcs_methods() -> frozenset:
    return frozenset(m for m, e in METHODS.items()
                     if e["service"].split("|")[0] == "gcs")


def gcs_mutations() -> frozenset:
    """Leader-only methods: the GCS surface minus follower reads and
    any-replica ring writes."""
    return gcs_methods() - GCS_FOLLOWER_READS - GCS_RING_WRITES
