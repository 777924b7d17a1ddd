"""Wire-level task/actor specifications (ref: src/ray/common/task/task_spec.h
semantics — everything a worker needs to execute a task, self-contained)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ant_ray_tpu_torch._private.ids import ActorID, JobID, NodeID, TaskID


class PromotedArgs:
    """Marker for task args promoted to the object plane: above
    max_inline_object_size the (args, kwargs) blob is put into plasma and
    the spec carries only this ref (ref: max_direct_call_object_size —
    large args never travel inside the control-plane RPC frame)."""

    __slots__ = ("ref",)

    def __init__(self, ref):
        self.ref = ref


@dataclass
class TaskSpec:
    """One task/actor-call submission, self-contained.

    Wire forms: the pickled positional tuple (``__reduce__`` below —
    the universal transport), and the hot-frame split
    (``_private/hotframe.py``): fields invariant per call shape
    (``TEMPLATE_FIELDS``) are interned once per connection, varying
    fields (``CALL_FIELDS``) ride each call struct-packed, and
    ``args_payload`` travels as raw bytes outside pickle entirely.
    Adding a field here means deciding which side of that split it
    lands on — the artlint frame-schema snapshot makes the choice
    explicit and append-only."""

    task_id: TaskID
    function_id: str              # GCS-KV key of the cloudpickled function
    function_name: str            # human-readable, for errors
    args_payload: bytes           # SerializedObject.to_payload() of (args, kwargs)
    num_returns: int
    owner_address: str            # core service addr of the submitting process
    resources: dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Actor-task fields
    actor_id: ActorID | None = None
    method_name: str = ""
    sequence_no: int = -1         # per-submitter ordering for actor tasks
    # Named executor pool this call runs in (ref: ConcurrencyGroupManager,
    # src/ray/core_worker/task_execution/concurrency_group_manager.h)
    concurrency_group: str = ""
    # Placement-group routing
    placement_group_id: "object | None" = None
    placement_group_bundle_index: int = -1
    # Wire-form runtime env (see _private/runtime_env.py)
    runtime_env: dict | None = None
    # Exact-match node-label constraint (ref: label_selector,
    # src/ray/common/scheduling/label_selector.h)
    label_selector: dict | None = None
    # Wire form of the scheduling strategy (None = hybrid default,
    # "SPREAD", or {"kind": "node_affinity", ...}; ref: the raylet
    # policy set, composite_scheduling_policy.h:33)
    scheduling_strategy: "dict | str | None" = None
    # Propagated trace context (observability/tracing_plane.py wire
    # tuple (trace_id, span_id, sampled)); None when the submission is
    # not part of a sampled trace — the zero-overhead common case.
    trace_ctx: "tuple | None" = None
    # Execution attempt (0 = first).  Mutated by the submitter before
    # each (re)push so the worker's task events and span ids can tell a
    # retry from the original run (span-id salt).
    attempt: int = 0

    def __reduce__(self):
        # Positional-tuple pickling: the default dataclass path pickles
        # a 19-key dict whose field-name strings are re-encoded in every
        # RPC frame (each frame is a fresh dumps with an empty memo) —
        # measurable at 10k specs/s on the actor-call hot path.
        return (TaskSpec, (
            self.task_id, self.function_id, self.function_name,
            self.args_payload, self.num_returns, self.owner_address,
            self.resources, self.max_retries, self.retry_exceptions,
            self.actor_id, self.method_name, self.sequence_no,
            self.concurrency_group, self.placement_group_id,
            self.placement_group_bundle_index, self.runtime_env,
            self.label_selector, self.scheduling_strategy,
            self.trace_ctx, self.attempt))


@dataclass
class ActorSpec:
    actor_id: ActorID
    class_id: str                 # GCS-KV key of the cloudpickled class
    class_name: str
    args_payload: bytes
    owner_address: str
    # Held for the actor's lifetime (default: none).
    resources: dict[str, float] = field(default_factory=dict)
    # Matched at scheduling time (default: 1 CPU).
    placement_resources: dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_concurrency: int = 1
    # name -> pool size; methods opt in via @method(concurrency_group=...)
    concurrency_groups: dict[str, int] | None = None
    name: str = ""
    namespace: str = "default"
    lifetime: str | None = None
    job_id: JobID | None = None
    placement_group_id: "object | None" = None
    placement_group_bundle_index: int = -1
    runtime_env: dict | None = None
    label_selector: dict | None = None
    # Wire-form scheduling strategy (see TaskSpec.scheduling_strategy).
    scheduling_strategy: "dict | str | None" = None


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str                  # node daemon RPC addr
    total_resources: dict[str, float] = field(default_factory=dict)
    available_resources: dict[str, float] = field(default_factory=dict)
    object_store_dir: str = ""
    alive: bool = True
    labels: dict[str, str] = field(default_factory=dict)
    # Filesystem-monitor state: a disk-full node keeps its membership
    # but is skipped by scheduling (ref: file_system_monitor.h).
    disk_full: bool = False
    # Drain state (ref: DrainNode / NodeDeathInfo in gcs.proto —
    # announced departures: TPU maintenance events, autoscaler
    # downscale, SIGTERM).  A DRAINING node keeps running its current
    # work but takes no new leases/bundles; schedulers skip it and
    # controllers migrate gangs/replicas off it before the deadline.
    draining: bool = False
    drain_reason: str = ""
    # Wall-clock (time.time()) by which the node expects to be gone;
    # 0.0 = no announced deadline.
    drain_deadline: float = 0.0


# Actor lifecycle states (ref: gcs_actor_manager state machine)
ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"
