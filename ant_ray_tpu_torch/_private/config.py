"""Global configuration flag table.

Equivalent in spirit to the reference's RAY_CONFIG macro table
(ref: src/ray/common/ray_config_def.h — 239 flags, env-overridable via
RAY_<name>), redesigned as a typed dataclass: every field is overridable with
an ``ART_<NAME>`` environment variable and with the ``_system_config`` dict
passed to :func:`ant_ray_tpu_torch.init`, which exports it to the processes
of the cluster it starts as those variables.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"ART_{name.upper()}")
    if raw is None:
        return default
    ty = type(default)
    if ty is bool:
        return raw.lower() in ("1", "true", "yes")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    if ty in (dict, list):
        return json.loads(raw)
    return raw


# Flags of the JAX package's table that the port does not carry, by the
# ROADMAP item (queue A) that brings the code that reads them.
UNPORTED_FLAGS = {
    **dict.fromkeys(("lockcheck", "lockcheck_hold_budget_s"),
                    "6.6, lockcheck's instrumented path"),
    **dict.fromkeys(("tpu_chips_override", "testing_preemption_notice",
                     "preemption_poll_interval_s"),
                    "9, GPU placement and the preemption watch "
                    "(init(num_gpus=) overrides the detected cards)"),
    **dict.fromkeys(("object_store_high_watermark",
                     "worker_lease_timeout_s"),
                    "none: no module of either package reads it"),
}


@dataclasses.dataclass
class Config:
    """The flags that the port's modules read: those of the JAX
    package's table whose readers are ported.  Naming any other flag
    fails loudly, naming the ROADMAP item that brings its reader
    (:data:`UNPORTED_FLAGS`)."""

    # ---- object store ----
    # Objects smaller than this are returned inline in RPC replies and live in
    # the owner's in-process memory store; larger ones go to the node's shared
    # memory store (ref: max_direct_call_object_size).
    max_inline_object_size: int = 100 * 1024
    # Per-node shared-memory store capacity (bytes). 0 = auto (30% of RAM).
    object_store_memory: int = 0
    # Chunk size for node-to-node object transfer.
    object_transfer_chunk_size: int = 8 * 1024 * 1024
    # Holder-side memo of recently served transfer chunks: a broadcast
    # to N nodes costs one store read per chunk, not N (ref: PushManager
    # chunk dedup, push_manager.h:28).  0 disables.
    transfer_chunk_cache_bytes: int = 64 * 1024 * 1024
    # Cap on a node's in-flight inbound transfer bytes; pulls beyond it
    # queue (ref: pull_manager.h:50 quota).  0 = unlimited.  A single
    # object larger than the quota still pulls (alone).  A striped pull
    # accounts its whole object size ONCE, not per stripe.
    pull_quota_bytes: int = 256 * 1024 * 1024
    # ReadChunk requests kept in flight per holder during a pull, so
    # transfer bandwidth is bounded by the wire, not chunk_size/RTT
    # (ref: PushManager's in-flight chunk window, push_manager.h:28).
    # 1 degenerates to the stop-and-wait protocol.
    object_pull_window: int = 8
    # Objects at least this large with >=2 registered holders pull
    # STRIPED: the chunk range is partitioned across holders and pulled
    # concurrently into the same grant (broadcast fan-in at k x NIC).
    # 0 disables striping.
    object_stripe_min_bytes: int = 16 * 1024 * 1024
    # Testing only: holder-side delay per served transfer chunk, so
    # tests can deterministically kill a holder mid-transfer.
    testing_chunk_serve_delay_s: float = 0.0
    # Testing only (chaos harness): truncate every bulk-channel chunk
    # reply to at most this many payload bytes (0 = off).  The puller
    # sees a short reply, fails the pump, and exercises the stripe
    # failover path deterministically.
    testing_chunk_truncate: int = 0
    # An unsealed arena grant younger than this is presumed live (its
    # producer is still writing); only older grants are reclaimed.
    unsealed_grant_ttl_s: float = 30.0
    # Arena read pins auto-expire after this long if the reader never
    # sends ReadDone (crashed client), so the slot becomes evictable.
    read_pin_ttl_s: float = 120.0
    # Zero-copy get() pins (arrays deserialized as views into the arena)
    # live until the consumer GCs the value; clients renew the lease at
    # TTL/3 (RenewPin heartbeat) while the value is referenced, so this
    # only bounds how long a *crashed* reader can wedge a slot.
    zero_copy_pin_ttl_s: float = 120.0
    # EnsureLocal fails fast after this many seconds with an empty
    # holder list, handing control to lineage reconstruction.
    pull_no_holders_grace_s: float = 2.0
    # Stream worker stdout/stderr lines to the driver console via GCS
    # pubsub (ref: log_monitor.py) — `print()` inside a task shows up
    # on the driver as `(worker=.. pid=..) line`.
    log_to_driver: bool = True
    # Mirror per-task lifecycle events into the export pipeline (ref:
    # the reference's per-source enable_export_api_write gates).  Off by
    # default: tasks are the one high-volume source and recording each
    # event costs real control-plane throughput.
    export_task_events: bool = False
    # Task lifecycle events (submitted/started/finished) buffered per
    # process and batch-flushed to the GCS — feeds the Chrome-trace
    # timeline and the state API (ref: task_event_buffer.h).
    enable_task_events: bool = True
    # Evicted sealed objects spill to disk (session dir) and restore on
    # access instead of being dropped (ref: LocalObjectManager).
    enable_object_spilling: bool = True
    # Per-node spill budget; past it, evictions drop instead of spill.
    max_spill_bytes: int = 10 * 1024 * 1024 * 1024

    # ---- operator surface (dashboard.py, node_agent.py) ----
    # Start the dashboard head (REST state API + /metrics) with the
    # cluster.
    include_dashboard: bool = True
    # Emit flow-insight call-graph events (ant-fork util/insight).
    enable_insight: bool = False
    # Spawn a per-node agent process (log serving, OS metrics, device
    # gauges, trace capture) supervised by the daemon (ref:
    # agent_manager.h + the dashboard agent).
    enable_node_agent: bool = True
    # Node-agent interval for publishing per-card memory gauges
    # (observability/device_stats.py) into the GCS metrics table.
    # 0 disables the publish loop (stats stay available on demand via
    # the AgentDeviceStats RPC).
    device_stats_interval_s: float = 15.0

    # ---- data engine ----
    # Max concurrent tasks per streaming-Data stage (map / split / merge).
    data_inflight_tasks: int = 8
    # Per-stage cap on estimated in-flight block bytes: further launches
    # wait once the sum of known in-window block sizes passes it (ref:
    # streaming executor backpressure policies,
    # data/_internal/execution/backpressure_policy/).  0 disables.
    data_inflight_bytes: int = 128 * 1024 * 1024
    # Target output block size: size-aware repartition/shuffle pick
    # their partition count from total bytes / this when the caller
    # gives no explicit block count.
    data_target_block_bytes: int = 32 * 1024 * 1024

    # ---- cgroup v2 isolation (ref: src/ray/common/cgroup2/) ----
    # Place workers in a sibling cgroup under a delegated cgroup2 tree
    # (opt-in; silently skipped when the tree isn't writable).
    enable_cgroups: bool = False
    # The delegated cgroup2 tree root (tests point this at a fake).
    cgroup_root: str = "/sys/fs/cgroup"
    # Collective memory.max for the workers cgroup (bytes; 0 = no cap).
    cgroup_workers_memory_max: int = 0
    # cpu.weight for the workers cgroup (0 = kernel default).
    cgroup_workers_cpu_weight: int = 0

    # ---- scheduling ----
    # Workers pre-started per node at boot (-1 = auto: min(2, num_cpus)).
    num_prestart_workers: int = -1
    # Upper bound on workers a node will fork (0 = num_cpus).
    max_workers_per_node: int = 0
    # Spill a queued task to another node if it has waited this long locally.
    spillback_timeout_s: float = 0.2
    # How long a task submission keeps following spillback redirects on
    # a busy cluster before giving up (the redirect chain itself is
    # unbounded, matching the reference submitter).
    lease_retry_deadline_s: float = 120.0
    # Lease reuse (ref: NormalTaskSubmitter scheduling-key entries,
    # normal_task_submitter.cc:185 — leased workers are reused for
    # queued tasks of the same scheduling key instead of paying a
    # lease/return RPC pair per task):
    # how long a drained worker lease lingers waiting for the next task
    # of its key before being returned to the node.
    task_lease_linger_s: float = 0.05
    # In-flight PushTask pipeline depth per leased worker (hides the RPC
    # round trip behind execution of the previous task).
    task_push_pipeline_depth: int = 8
    # Max concurrent LeaseWorker requests parked per scheduling key.
    max_pending_lease_requests: int = 8
    # Worker leases requested per LeaseWorker round trip: a burst of N
    # queued tasks asks the daemon for up to this many workers in ONE
    # RPC (payload ``count``); the daemon grants extras only from
    # already-idle capacity (reply ``extra``), and grants the queue
    # drained past are returned immediately.  1 restores the one-lease-
    # per-round-trip protocol (and is what pre-batching daemons serve).
    lease_batch_size: int = 8
    # Pull-before-grant budget for a lease's plasma args (ref:
    # LeaseDependencyManager, lease_dependency_manager.h): the daemon
    # pulls the first queued task's deps node-local before granting,
    # waiting at most this long.  0 disables.
    lease_dep_prefetch_timeout_s: float = 10.0

    # ---- fault tolerance ----
    task_max_retries_default: int = 3
    actor_max_restarts_default: int = 0
    # Node heartbeat period and the number of missed beats before death.
    heartbeat_period_s: float = 0.5
    num_heartbeats_timeout: int = 10
    # Stagger each node's heartbeat phase by a hash of its node id
    # within heartbeat_period_s, so N daemons booted together cannot
    # synchronize into ingest storms at the GCS.
    heartbeat_jitter: bool = True
    # Cap on the exponential backoff a daemon applies between CONSECUTIVE
    # failed heartbeat sends (a flapping GCS link must not busy-spin);
    # kept well under the death timeout so one recovered beat still
    # lands in time.
    heartbeat_backoff_cap_s: float = 2.0
    # A node daemon whose GCS has been unreachable this long exits
    # (fail-stop for orphans; GCS FT restarts return well inside it).
    # 0 disables.
    gcs_dead_exit_s: float = 60.0
    # Remote lease-owner liveness sweep (node_daemon): ping period and
    # the number of consecutive failed pings before a reclaim is even
    # considered.  High-latency deployments raise these; the reclaim
    # additionally corroborates with GCS node liveness — an owner
    # whose node is still heartbeating is never reclaimed over a
    # transient partition between daemon and owner.
    lease_owner_sweep_interval_s: float = 3.0
    lease_owner_ping_strikes: int = 3
    # Hybrid (DEFAULT) scheduling: pack onto feasible nodes until their
    # utilization passes this, then spread (ref:
    # hybrid_scheduling_policy.h spread_threshold).
    hybrid_pack_threshold: float = 0.5
    # Sticky pack-pick cache in the GCS scheduler: reuse the last grant
    # target per plain scheduling shape (revalidated against live state)
    # instead of an O(nodes) feasibility scan per lease — the worst
    # measured cliff in the 500-node scale harness.  Off restores the
    # full-scan-per-lease behaviour (the harness's "before" arm).
    sched_pick_cache: bool = True
    # Node-side virtual-cluster fencing verdicts are cached this long
    # before re-checking with the GCS (ant ref: virtual-cluster GC/TTL
    # flags, ray_config_def.ant.h).
    vc_fence_ttl_s: float = 5.0

    # ---- autoscaler ----
    # How long an infeasible task waits for the autoscaler to provision
    # a node before failing (only applies while an autoscaler heartbeat
    # is live; without one infeasible fails fast).
    infeasible_wait_s: float = 300.0

    # ---- GCS HA (replicated control plane) ----
    # Leader lease TTL: a leader that cannot renew within it is fenced
    # out and a standby takes over — the dominant term in failover time.
    gcs_ha_lease_ttl_s: float = 2.0
    # How often the holder renews (and standbys poll) the lease.
    gcs_ha_renew_period_s: float = 0.4
    # Follower store-sync period: bounds follower-read staleness and
    # the replication lag reported in the HA view.
    gcs_ha_sync_period_s: float = 0.25
    # Client-side failover budget: how long the GCS router keeps
    # re-resolving the leader (capped-backoff probes over the known
    # replica set) after a connection failure before surfacing the
    # error.  Only applies when the client knows >1 replica.
    gcs_failover_timeout_s: float = 15.0
    # Remote-store read fence budget (store_client.RemoteStoreClient):
    # how long a read waits for the ordered write queue to drain before
    # failing with a typed StoreFenceError.  A fence miss must surface,
    # not silently return possibly-stale state — follower reads build
    # their read-your-writes guarantee on this.
    store_fence_timeout_s: float = 10.0

    # ---- rpc ----
    rpc_connect_timeout_s: float = 10.0
    rpc_call_timeout_s: float = 60.0
    # Hot-frame wire protocol (hotframe.py): the zero-pickle PushTask
    # path — struct-packed calls against per-connection header
    # templates, with coalesced batched acks.  Negotiated per
    # connection in the HELLO handshake; disabling it (or talking to a
    # peer that has it disabled / predates it) transparently falls back
    # to the pickled frames, call for call.
    hot_wire_enabled: bool = True
    # Deterministic RPC fault injection: "method:prob,method:prob" (chaos
    # testing — ref: src/ray/rpc/rpc_chaos.h).
    testing_rpc_failure: str = ""
    # Deterministic RPC latency injection: "method:seconds,method:seconds"
    # (chaos harness — slow-replica / slow-network scenarios; the delay
    # is added client-side before the frame is written, so it rides the
    # same per-daemon env channel as testing_rpc_failure).
    testing_rpc_latency_s: str = ""

    # ---- memory monitor (ref: src/ray/common/memory_monitor.h +
    # worker_killing_policy.h) ----
    # Check node memory pressure this often; 0 disables the monitor.
    memory_monitor_interval_s: float = 1.0
    # Above this used fraction, the daemon kills a worker to relieve
    # pressure (retriable task workers first, largest RSS first).
    memory_usage_threshold: float = 0.95
    # Where to read meminfo (tests point this at a fake file).
    meminfo_path: str = "/proc/meminfo"

    # ---- filesystem monitor (ref: src/ray/common/file_system_monitor.h:
    # above the capacity threshold a node stops taking new work so
    # spill/log writes can't wedge the whole node).  0 interval disables.
    fs_monitor_interval_s: float = 5.0
    local_fs_capacity_threshold: float = 0.95

    # ---- draining ----
    # Default drain grace (seconds) announced with a preemption-driven
    # drain when the notice itself carries no deadline — consumers
    # (Train controllers, Serve) must be off the node within it.
    drain_deadline_s: float = 30.0

    # ---- tracing (observability/tracing_plane.py) ----
    # Head-sampling rate for request traces: the coin is flipped ONCE at
    # each ingress (serve HTTP/gRPC request, handle.call, driver
    # .remote()) and the verdict propagates with the context, Dapper
    # style.  Error/shed spans are force-sampled regardless.  1.0 traces
    # everything (tests/debugging); 0 disables minting sampled traces.
    trace_sample_rate: float = 0.01
    # Per-process flight-recorder ring size (spans).  Force-sampled
    # error spans keep a separate ring of size/4 so healthy traffic
    # wrapping the main ring never evicts failure evidence.
    flight_recorder_size: int = 4096
    # Sampled spans batch-published to the GCS span ring once this many
    # are pending (age-flushed at 1s regardless).
    trace_publish_batch: int = 128

    # ---- cluster state observatory (_private/task_state.py) ----
    # Per-job cap on the GCS task-state table (ref: GcsTaskManager's
    # MAX_NUM_TASK_EVENTS_PER_JOB GC policy, gcs_task_manager.h:60):
    # once a job exceeds this many (task, attempt) records, finished
    # attempts are evicted first (oldest first), then the oldest
    # non-terminal records; evictions surface as num_tasks_dropped in
    # ListTasks/SummarizeTasks/GetTask stats so operators know the
    # view is clipped.
    task_table_max_per_job: int = 10000
    # Record the creation callsite (file:line outside the framework) of
    # plasma objects at put() time, surfaced by `art memory` /
    # /api/memory.  Off by default: the stack walk costs ~microseconds
    # per put and the strings cost directory memory.
    record_object_callsite: bool = False

    # ---- continuous CPU profiling (observability/cpu_profiler.py) ----
    # Sampling rate of the always-on profiler in every process class
    # (driver, GCS, node daemon, workers, node agent).  67 Hz is a prime
    # that avoids lockstep with 10ms/100ms periodic work; 0 disables
    # the whole profiling plane (sampler, publication, wire-counter
    # rollups).  Env channel: ART_CPU_PROFILE_HZ.
    cpu_profile_hz: float = 67.0
    # How often each process publishes its folded-stack delta (and its
    # wire-accounting counter deltas) to the GCS CpuProfileAdd ring.
    cpu_profile_publish_period_s: float = 2.5
    # Bound on DISTINCT folded stacks aggregated per process; once full,
    # new stacks collapse into a single "(overflow)" bucket.
    cpu_profile_max_stacks: int = 800

    # ---- logging ----
    log_level: str = "INFO"

    def apply_env_overrides(self) -> "Config":
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))
        return self

    def apply_dict(self, overrides: dict | None) -> "Config":
        if not overrides:
            return self
        for key, value in overrides.items():
            if not hasattr(self, key):
                item = UNPORTED_FLAGS.get(key)
                raise ValueError(
                    f"Unknown config flag: {key} " + (
                        f"(not ported: ROADMAP queue A item {item})" if item
                        else "(a flag of neither package)"))
            setattr(self, key, value)
        return self


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_global_config(config: Config) -> None:
    global _global_config
    _global_config = config
