"""ClusterRuntime — the in-process runtime for drivers and workers.

Role of the reference's CoreWorker (ref: src/ray/core_worker/core_worker.h:167):
task/actor submission with leases and per-actor ordered pipelining, the
owner-side memory store, the put/get object paths (inline, shm plasma, remote
pull), borrower registration, and reference counting that frees objects
cluster-wide when the last handle dies.

Every driver/worker process runs one "core service" RPC server so borrowers
can fetch owned objects directly from their owner (ownership-based object
resolution — ref: OwnershipObjectDirectory).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import uuid
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Sequence

import asyncio

from ant_ray_tpu_torch import exceptions
from ant_ray_tpu_torch._private import serialization
from ant_ray_tpu_torch._private.config import Config, global_config
from ant_ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    ObjectID,
    TaskID,
    WorkerID,
)
from ant_ray_tpu_torch._private import task_events
from ant_ray_tpu_torch._private.memory_store import MemoryStore
from ant_ray_tpu_torch._private.object_store import ArenaClient, open_object
from ant_ray_tpu_torch._private.protocol import (
    ClientPool,
    IoThread,
    RawReply,
    RpcConnectionError,
    RpcError,
    RpcServer,
    _spawn,
)
from ant_ray_tpu_torch._private.specs import (
    ACTOR_ALIVE,
    ACTOR_DEAD,
    ACTOR_RESTARTING,
    ActorSpec,
    PromotedArgs,
    TaskSpec,
)
from ant_ray_tpu_torch._private.task_options import ActorOptions, TaskOptions
from ant_ray_tpu_torch.util.scheduling_strategies import strategy_wire
from ant_ray_tpu_torch._private.worker import CoreRuntime
from ant_ray_tpu_torch.object_ref import ObjectRef, set_refcount_hook
from ant_ray_tpu_torch.observability import tracing_plane

logger = logging.getLogger(__name__)


class _AllCopiesLost(Exception):
    """Internal: EnsureLocal reported an empty holder list — every copy
    of the plasma object is gone; try lineage reconstruction."""

    def __init__(self, oid: ObjectID):
        super().__init__(oid.hex())
        self.oid = oid


@dataclass
class _StreamState:
    """Owner-side bookkeeping of one streaming task's returns
    (ref: ObjectRefStream, src/ray/core_worker/task_manager.h:67)."""

    received: int = 0                  # contiguous items stored so far
    total: int | None = None           # set by the end-of-stream marker
    error: Exception | None = None     # mid-stream task failure
    cond: threading.Condition = field(
        default_factory=threading.Condition)


@dataclass
class _SchedKeyState:
    """Per-scheduling-key task queue + leased-worker pool (ref:
    NormalTaskSubmitter's scheduling_key_entries_,
    task_submission/normal_task_submitter.h:295 — tasks with the same
    (resources, runtime_env, placement, labels) share worker leases
    instead of paying a lease/return RPC pair each)."""

    resources: dict
    runtime_env: Any
    label_selector: dict | None
    pg: tuple | None                  # (pg_id, bundle_index) if any
    strategy: Any = None              # wire-form scheduling strategy
    queue: deque = field(default_factory=deque)  # (spec, pinned, attempt)
    workers: int = 0                  # granted leases currently draining
    busy: int = 0                     # of those, executing a task now
    acquiring: int = 0                # LeaseWorker requests in flight
    wakeup: asyncio.Event = field(default_factory=asyncio.Event)


@dataclass
class _ActorSubmitState:
    """Per-actor ordered submission queue
    (ref: ActorTaskSubmitter, task_submission/actor_task_submitter.h:68)."""

    actor_id: ActorID
    address: str = ""
    next_seq: int = 0
    queue: deque = field(default_factory=deque)
    sender_running: bool = False
    dead_reason: str | None = None


# Precomputed wire form of "no arguments" — the most common actor-call
# shape; skips a serializer pass per call.
_EMPTY_ARGS_PAYLOAD = serialization.serialize(((), {})).to_payload()


def _serialized_args(args, kwargs) -> serialization.SerializedObject:
    """A call's ``(args, kwargs)`` serialized, or ``args`` itself where a
    proxy passes them on already serialized (util/client/server.py)."""
    if isinstance(args, serialization.SerializedObject):
        return args
    return serialization.serialize((args, kwargs))


_FRAMEWORK_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _creation_callsite(limit: int = 12) -> str | None:
    """First stack frame OUTSIDE the framework — the user line that
    created the object (behind config.record_object_callsite; walked
    only when the knob is on)."""
    import sys  # noqa: PLC0415

    frame = sys._getframe(1)
    for _ in range(limit):
        if frame is None:
            return None
        filename = frame.f_code.co_filename
        if not filename.startswith(_FRAMEWORK_DIR):
            return f"{filename}:{frame.f_lineno}"
        frame = frame.f_back
    return None


class _ArenaPin:
    """Owner of one daemon-side arena read pin.  Values deserialized
    zero-copy from the pinned window hold this object (via
    serialization pinned-buffer bases); when the last of them is GC'd
    the finalizer ships ReadDone, letting the store evict the slot.
    While alive it sits in the runtime's live-pin set, whose renewal
    loop heartbeats RenewPin so a long-held value (e.g. model weights
    for a whole run) never outlives its daemon-side lease."""

    __slots__ = ("_finalizer", "oid", "token", "__weakref__")

    def __init__(self, release, oid, token):
        self.oid = oid
        self.token = token
        self._finalizer = weakref.finalize(self, release)


class _BlockedCtx:
    """Blocked-in-get() marker for the node daemon (module-level: this is
    entered on every get(), so it must not define classes or closures)."""

    __slots__ = ("_runtime",)

    def __init__(self, runtime):
        self._runtime = runtime

    def __enter__(self):
        runtime = self._runtime
        if runtime.role == "worker" and runtime.worker_id is not None:
            with runtime._blocked_lock:
                runtime._blocked_depth += 1
                if runtime._blocked_depth == 1:
                    runtime._send_oneway(
                        runtime.node_address, "WorkerBlocked",
                        {"worker_id": runtime.worker_id})
        return self

    def __exit__(self, *exc):
        runtime = self._runtime
        if runtime.role == "worker" and runtime.worker_id is not None:
            with runtime._blocked_lock:
                runtime._blocked_depth -= 1
                if runtime._blocked_depth == 0:
                    runtime._send_oneway(
                        runtime.node_address, "WorkerUnblocked",
                        {"worker_id": runtime.worker_id})


class ClusterRuntime(CoreRuntime):
    def __init__(self, *, role: str, job_id: JobID, gcs_address: str,
                 node_address: str, store_dir: str,
                 worker_id: WorkerID | None = None,
                 owned_processes: list | None = None,
                 session_dir: str = ""):
        self.role = role
        self.job_id = job_id
        self._io = IoThread.get()
        self._clients = ClientPool()
        self._gcs = self._clients.get(gcs_address)
        self._node = self._clients.get(node_address)
        self.gcs_address = gcs_address
        self.node_address = node_address
        self.store_dir = store_dir
        self.worker_id = worker_id
        self._owned_processes = owned_processes or []
        self.session_dir = session_dir
        self.namespace = "default"

        self.memory = MemoryStore(self._io.loop)
        self.server = RpcServer()
        self.server.routes({
            # Liveness probe (the node daemon's lease-owner sweep pings
            # lessees; an unroutable Ping would read as "owner dead").
            "Ping": self._handle_ping,
            "GetObject": self._handle_get_object,
            "GetObjectStatus": self._handle_get_object_status,
            "GetObjectStatusBatch": self._handle_get_object_status_batch,
            "WaitObjects": self._handle_wait_objects,
            "GetObjectInfo": self._handle_get_object_info,
            "GetOwnedRefInfo": self._handle_get_owned_ref_info,
            "BorrowAdd": self._handle_borrow_add,
            "BorrowRemove": self._handle_borrow_remove,
            "ReconstructObject": self._handle_reconstruct_object,
            "DeviceTensorFetch": self._handle_device_tensor_fetch,
            "DeviceTensorFree": self._handle_device_tensor_free,
            "DeviceTensorSendVia": self._handle_device_tensor_send_via,
            "StreamItem": self._handle_stream_item,
        })
        self._streams: dict[TaskID, _StreamState] = {}
        # abandoned stream ids (insertion-ordered; bounded) — late items
        # for these are dropped, not stored
        self._released_streams: dict[TaskID, bool] = {}
        # Card-resident tensors held by this worker, keyed by holder
        # token, plus the metadata-oid → token map that ties payload
        # lifetime to the metadata object's refcount
        # (see experimental/device_objects.py)
        self._device_objects: dict[str, Any] = {}
        self._device_tokens_by_oid: dict[ObjectID, str] = {}
        self.address = self.server.start()

        self._driver_task_id = TaskID.for_driver_task(job_id)
        self._put_index = 0
        from ant_ray_tpu_torch._lint.lockcheck import make_lock, make_rlock  # noqa: PLC0415

        self._put_lock = make_lock("core.put_index")

        # ---- reference counting state (owner side)
        self._local_refs: dict[ObjectID, int] = {}
        self._borrows: dict[ObjectID, int] = {}       # borrows of objects I own
        self._pins: dict[ObjectID, int] = {}          # in-flight task args
        # nested refs pinned for the lifetime of an owned outer object
        # (put() of a value containing refs) — released when the outer
        # object is freed, so inner objects don't leak (ref: nested-ref
        # release in ReferenceCounter, reference_counter.h:44)
        self._contained_pins: dict[ObjectID, list] = {}
        # refs pinned inside actor-constructor args — released when the
        # actor can no longer restart (killed or permanently dead)
        self._actor_ctor_pins: dict[ActorID, list] = {}
        self._borrowed_from: dict[ObjectID, str] = {} # owner addr of my borrows
        # Reentrant: dropping the last Python reference to an ObjectRef
        # *inside* a locked region (e.g. releasing a _contained_pins list,
        # or a cyclic-GC pass triggered by any allocation while the lock
        # is held) fires ObjectRef.__del__ → _refcount_event on the same
        # thread; a plain Lock self-deadlocks there.  The nested calls
        # only do per-key dict ops, which compose safely.
        self._ref_lock = make_rlock("core.refcount")
        set_refcount_hook(self._refcount_event)

        # ---- function/class export
        self._fetch_cache: dict[str, Any] = {}        # kv key -> callable/class

        # ---- lineage (owner side): plasma return -> producing TaskSpec,
        # re-executed when every copy of the object is lost
        # (ref: TaskManager lineage + ObjectRecoveryManager,
        #  src/ray/core_worker/object_recovery_manager.h:98-108)
        self._lineage: dict[ObjectID, TaskSpec] = {}
        self._reconstructions: dict[TaskID, asyncio.Future] = {}

        self._sched_states: dict[tuple, _SchedKeyState] = {}
        self._actor_states: dict[ActorID, _ActorSubmitState] = {}
        # Cross-thread submission inbox: app threads append, one
        # call_soon_threadsafe wakeup drains the burst — a wakeup per
        # call is an eventfd syscall each, visible at 10k calls/s.
        self._submit_inbox: deque = deque()
        self._inbox_scheduled = False  # GIL-atomic flag
        # Coalesced best-effort oneway publishes (refcount borrows,
        # cluster-wide frees): any thread appends, one io-loop drain
        # groups the burst per destination and ships each group as ONE
        # transport write — per-event frames and wakeups are visible at
        # 10k calls/s.  A single sequential drainer preserves per-
        # destination ordering (BorrowAdd before BorrowRemove).
        self._oneway_inbox: deque = deque()
        self._oneway_scheduled = False  # GIL-atomic flag
        self._oneway_draining = False   # io-loop confined
        # Shared bound method for the per-call reply callback: binding
        # once avoids a closure + bound-method allocation per call on
        # the actor-reply hot path.
        self._actor_reply_cb = self._on_actor_reply_done
        self._actor_meta_cache: dict[ActorID, dict] = {}
        self._pg_bundle_cache: dict = {}  # pg_id -> [node addresses]
        self._renv_cache: dict = {}       # runtime_env -> wire form
        self._arena_client = ArenaClient()
        # Live zero-copy pins (weak: pins die when their values are
        # GC'd); the renewal loop heartbeats their daemon leases.
        self._live_pins = weakref.WeakSet()
        self._pin_renewer_started = False
        self._blocked_depth = 0
        self._blocked_lock = make_lock("core.blocked_depth")
        self._shutdown = False
        # Long-poll subscription to GCS pubsub channels: actor deaths
        # arrive as pushes, so idle processes make ~0 RPCs/s and failure
        # news beats the next failed call
        # (ref: src/ray/pubsub/publisher.h subscriber side).
        self._pubsub_task = asyncio.run_coroutine_threadsafe(
            self._pubsub_loop(), self._io.loop)

    # ------------------------------------------------------------ bootstrap

    @classmethod
    def create(cls, *, address: str | None, job_id: JobID,
               num_cpus: int | None, num_tpus: int | None,
               resources: dict | None, namespace: str,
               config: Config,
               num_gpus: int | None = None) -> "ClusterRuntime":
        from ant_ray_tpu_torch._private import services  # noqa: PLC0415

        if address is None:
            boot = services.start_cluster(
                num_cpus=num_cpus, num_tpus=num_tpus, resources=resources,
                num_gpus=num_gpus)
            gcs_address = boot["gcs_address"]
            node_address = boot["node_address"]
            store_dir = boot["store_dir"]
            owned = boot["processes"]
            session_dir = boot["session_dir"]
            dashboard_url = boot.get("dashboard_url", "")
        else:
            gcs_address = address.removeprefix("art://")
            node_address, store_dir = services.find_local_node(gcs_address)
            owned = []
            session_dir = ""
            dashboard_url = ""

        try:
            runtime = cls(role="driver", job_id=job_id,
                          gcs_address=gcs_address,
                          node_address=node_address, store_dir=store_dir,
                          owned_processes=owned, session_dir=session_dir)
        except BaseException:
            services.stop_processes(owned)
            if owned:
                services.remove_session_dir(session_dir)
            raise
        # The job's namespace: the default for the actors it names and
        # looks up (the JAX package takes the argument and uses
        # "default" regardless).
        runtime.namespace = namespace
        if not dashboard_url:
            blob = runtime._gcs.call("KVGet", {"key": "dashboard_url"},
                                     retries=3)
            dashboard_url = blob.decode() if blob else ""
        runtime.dashboard_url = dashboard_url
        runtime._gcs.call(
            "RegisterJob",
            {"job_id": job_id, "driver_address": runtime.address},
            retries=3)
        return runtime

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        task = getattr(self, "_pubsub_task", None)
        if task is not None:
            task.cancel()
        set_refcount_hook(None)
        from ant_ray_tpu_torch._private import services  # noqa: PLC0415

        if self._owned_processes:
            try:
                self._gcs.call("Shutdown", timeout=2)
            except Exception:  # noqa: BLE001
                pass
            services.stop_processes(self._owned_processes)
            # The arena went with the node daemon; the session's logs,
            # GCS store and spill files go with the cluster.
            services.remove_session_dir(self.session_dir)
        self.server.stop()
        self._clients.close_all()

    # ------------------------------------------------------------ pubsub

    async def _pubsub_loop(self):
        channels = ["actor_state"]
        if self.role == "driver" and global_config().log_to_driver:
            # Drivers also stream worker stdout/stderr lines (ref:
            # log_monitor.py — `print()` in a task appears here).
            channels.append("worker_logs")
        cursor = -1  # start from "now" — no interest in history
        while not self._shutdown:
            try:
                reply = await self._gcs.call_async(
                    "SubPoll", {"channels": tuple(channels),
                                "cursor": cursor, "timeout": 25.0},
                    timeout=35)
            except asyncio.CancelledError:
                return
            except Exception:  # noqa: BLE001 — head restarting
                # A restarted head's sequence restarts at 0; resuming
                # with the old (large) cursor would silence the channel
                # forever.  Resubscribe from "now".
                cursor = -1
                await asyncio.sleep(1.0)
                continue
            cursor = reply["cursor"]
            for _seq, channel, data in reply["events"]:
                try:
                    self._on_pubsub_event(channel, data)
                except Exception:  # noqa: BLE001
                    logger.exception("pubsub event handling failed")

    def _on_pubsub_event(self, channel: str, data: dict) -> None:
        if channel == "worker_logs":
            # Worker output → driver console, ray-style prefixes.
            # Job-scoped: on shared clusters another driver's task
            # output stays off this console (entries without a job tag
            # — e.g. a worker booting — print everywhere).
            node = data.get("node", "?")
            my_job = self.job_id.hex() if self.job_id else None
            for entry in data.get("entries", ()):
                entry_job = entry.get("job_id")
                if entry_job is not None and my_job is not None \
                        and entry_job != my_job:
                    continue
                prefix = f"(worker={entry.get('worker', '?')}" + (
                    f" pid={entry['pid']}" if entry.get("pid") else "") + \
                    f" node={node})"
                for line in entry.get("lines", ()):
                    print(f"{prefix} {line}", flush=True)
            return
        if channel == "actor_state":
            state = self._actor_states.get(data["actor_id"])
            if state is None:
                return
            if data["state"] == ACTOR_DEAD:
                # Push-based death: queued and future calls fail fast
                # instead of each discovering it via its own RPC.
                state.dead_reason = (data.get("death_reason")
                                     or "actor died")
                state.address = ""
                self._release_actor_ctor_pins(data["actor_id"])
            elif data["state"] == ACTOR_RESTARTING:
                state.address = ""
            elif data["state"] == ACTOR_ALIVE and data.get("address"):
                state.address = data["address"]

    # ------------------------------------------------------------ refcount

    def _refcount_event(self, event: str, ref: ObjectRef):
        if self._shutdown:
            return
        oid = ref.id
        with self._ref_lock:
            if event in ("add", "deserialized"):
                self._local_refs[oid] = self._local_refs.get(oid, 0) + 1
                if event == "deserialized" and not self.memory.is_owned(oid):
                    self._borrowed_from[oid] = ref.owner_address
                    self._send_oneway(ref.owner_address, "BorrowAdd",
                                      {"object_id": oid})
            elif event == "remove":
                count = self._local_refs.get(oid, 0) - 1
                if count > 0:
                    self._local_refs[oid] = count
                    return
                self._local_refs.pop(oid, None)
                owner = self._borrowed_from.pop(oid, None)
                if owner is not None:
                    self._send_oneway(owner, "BorrowRemove",
                                      {"object_id": oid})
                elif self.memory.is_owned(oid):
                    self._maybe_free_locked(oid)

    def _maybe_free_locked(self, oid: ObjectID):
        """Free an owned object once local refs, borrows and pins are gone."""
        if (self._local_refs.get(oid, 0) == 0
                and self._borrows.get(oid, 0) == 0
                and self._pins.get(oid, 0) == 0):
            entry = self.memory.get_entry(oid)
            self.memory.delete(oid)
            self._lineage.pop(oid, None)  # freed ⇒ lineage released
            token = self._device_tokens_by_oid.pop(oid, None)
            if token is not None:
                self._device_objects.pop(token, None)  # card memory released
            if entry is not None and entry[0] == "plasma":
                self._send_oneway(self.gcs_address, "FreeObject",
                                  {"object_id": oid})
            # Freeing the outer object releases its nested-ref pins
            # (may cascade into freeing the inner objects too).
            inner = self._contained_pins.pop(oid, None)
            if inner:
                self._unpin_locked(inner)

    def _send_oneway(self, address: str, method: str, payload):
        if not address or address == "local":
            return
        # The flag is cleared on the loop before draining, so an append
        # racing the drain at worst costs a redundant wakeup.
        self._oneway_inbox.append((address, method, payload))
        if not self._oneway_scheduled:
            self._oneway_scheduled = True
            self._io.loop.call_soon_threadsafe(self._kick_oneways)

    def _kick_oneways(self) -> None:
        # io-loop only.  ONE drainer coroutine at a time: interleaved
        # drains could reorder a destination's events (BorrowRemove
        # overtaking its BorrowAdd corrupts refcounts).
        self._oneway_scheduled = False
        if self._oneway_draining:
            return
        self._oneway_draining = True
        # _spawn, not bare ensure_future: the drainer suspends on
        # socket writes and the loop holds only weak task refs.
        _spawn(self._drain_oneways())

    async def _drain_oneways(self) -> None:
        try:
            while self._oneway_inbox:
                grouped: dict[str, list] = {}
                inbox = self._oneway_inbox
                while inbox:
                    address, method, payload = inbox.popleft()
                    grouped.setdefault(address, []).append(
                        (method, payload))
                for address, items in grouped.items():
                    try:
                        await self._clients.get(address).oneway_many(items)
                    except Exception:  # noqa: BLE001 — best-effort msgs
                        pass
        finally:
            self._oneway_draining = False
            if self._oneway_inbox:
                self._kick_oneways()

    async def _handle_ping(self, _payload):
        return "pong"

    async def _handle_borrow_add(self, payload):
        with self._ref_lock:
            oid = payload["object_id"]
            self._borrows[oid] = self._borrows.get(oid, 0) + 1
        return True

    async def _handle_borrow_remove(self, payload):
        with self._ref_lock:
            oid = payload["object_id"]
            count = self._borrows.get(oid, 0) - 1
            if count <= 0:
                self._borrows.pop(oid, None)
                self._maybe_free_locked(oid)
            else:
                self._borrows[oid] = count
        return True

    def _pin(self, refs: Sequence[ObjectRef]):
        with self._ref_lock:
            self._pin_locked(refs)

    def _pin_locked(self, refs: Sequence[ObjectRef]):
        for ref in refs:
            self._pins[ref.id] = self._pins.get(ref.id, 0) + 1

    def _unpin(self, refs: Sequence[ObjectRef]):
        with self._ref_lock:
            self._unpin_locked(refs)

    def _unpin_locked(self, refs: Sequence[ObjectRef]):
        for ref in refs:
            count = self._pins.get(ref.id, 0) - 1
            if count <= 0:
                self._pins.pop(ref.id, None)
                if self.memory.is_owned(ref.id):
                    self._maybe_free_locked(ref.id)
            else:
                self._pins[ref.id] = count

    # ------------------------------------------------------------ export

    def export(self, obj: Any, kind: str) -> str:
        """Export a function/class definition to GCS KV, content-addressed.

        The memo lives on the object itself (never key a cache by id():
        CPython reuses addresses of collected objects, which would hand a
        new function a dead function's export key).
        """
        memo = getattr(obj, "__art_export_key__", None)
        if memo is not None:
            memo_cluster, key = memo
            # The memo is only valid for the cluster it was exported to —
            # a driver that init()s a second cluster must re-upload or
            # workers there will miss the definition.
            if memo_cluster == self.gcs_address:
                return key
        blob = serialization.dumps_code(obj)
        key = f"{kind}:{hashlib.sha256(blob).hexdigest()[:24]}"
        self._gcs.call("KVPut", {"key": key, "value": blob,
                                 "overwrite": False}, retries=3)
        try:
            obj.__art_export_key__ = (self.gcs_address, key)
        except (AttributeError, TypeError):
            pass  # unmemoizable (e.g. builtin): re-pickle next time
        return key

    def fetch_code(self, key: str) -> Any:
        obj = self._fetch_cache.get(key)
        if obj is None:
            blob = self._gcs.call("KVGet", {"key": key}, retries=3)
            if blob is None:
                raise RuntimeError(f"definition {key} not found in GCS KV")
            obj = serialization.loads_code(blob)
            self._fetch_cache[key] = obj
        return obj

    # ------------------------------------------------------------ put/get

    def _next_put_id(self) -> ObjectID:
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        return ObjectID.for_task_return(self._driver_task_id,
                                        0x8000_0000 + idx)

    def put_serialized(self, ser: serialization.SerializedObject,
                       object_id: ObjectID | None = None) -> ObjectRef:
        oid = object_id or self._next_put_id()
        if ser.contained_refs:
            with self._ref_lock:  # nested refs live while the object does
                self._pin_locked(ser.contained_refs)
                self._contained_pins.setdefault(oid, []).extend(
                    ser.contained_refs)
        nbytes = ser.payload_nbytes()
        if nbytes <= global_config().max_inline_object_size:
            self.memory.put(oid, "inline", ser.to_payload())
        else:
            self._write_plasma(oid, ser)
            self.memory.put(oid, "plasma", nbytes)
        return ObjectRef(oid, owner_address=self.address)

    def put(self, value: Any) -> ObjectRef:
        return self.put_serialized(serialization.serialize(value))

    def _write_plasma(self, oid: ObjectID,
                      ser: serialization.SerializedObject):
        """Zero-copy produce: grant a write window in the node's arena
        and serialize straight into shared memory — the value's buffers
        are copied exactly once end-to-end (plasma create→seal; falls
        back to a tmp file when the native arena is unavailable)."""
        size = ser.payload_nbytes()
        # Attribution riding the seal (additive keys): the directory
        # learns who produced the object, so `art memory` can name the
        # owner — and, behind the record_object_callsite knob, where in
        # user code the put happened.
        seal_extra: dict = {"owner": self.address}
        if global_config().record_object_callsite:
            callsite = _creation_callsite()
            if callsite:
                seal_extra["callsite"] = callsite
        deadline = time.monotonic() + 60
        while True:
            grant = self._node.call("CreateBuffer",
                                    {"object_id": oid, "size": size},
                                    timeout=60)
            if grant.get("offset") is not None:
                view = self._arena_client.view(grant["path"], grant["offset"],
                                               size)
                ser.write_into(view)
                self._node.call("SealBuffer",
                                {"object_id": oid, **seal_extra},
                                timeout=60)
                return
            if grant.get("exists"):
                return  # idempotent re-put
            if grant.get("busy"):
                # Another producer/pull holds a live grant for this id —
                # it will seal the identical payload; wait for it.
                if time.monotonic() >= deadline:
                    raise exceptions.ObjectLostError(
                        oid, "timed out waiting on a concurrent producer")
                time.sleep(0.02)
                continue
            break
        tmp = os.path.join(self.store_dir,
                           f"{oid.hex()}.tmp.{uuid.uuid4().hex[:8]}")
        with open(tmp, "wb") as f:
            f.write(ser.to_payload())
        self._node.call("SealObject",
                        {"object_id": oid, "tmp_path": tmp, **seal_extra},
                        timeout=60)

    async def _handle_get_object(self, payload):
        """Owner-side object serving for borrowers."""
        oid = payload["object_id"]
        timeout = payload.get("timeout")
        if not self.memory.is_owned(oid):
            return ("unknown", None)
        try:
            kind, value = await self.memory.wait_async(oid, timeout)
        except asyncio.TimeoutError:
            return ("pending", None)
        return (kind, value)

    async def _handle_get_object_status(self, payload):
        return self._status_of(payload["object_id"])

    def _status_of(self, oid: ObjectID) -> str:
        entry = self.memory.get_entry(oid)
        if entry is None:
            return "unknown"
        return "ready" if entry[0] != "pending" else "pending"

    async def _handle_get_object_status_batch(self, payload):
        """One status round trip for a whole batch of refs — waiting on
        N borrowed refs of one owner costs one RPC per round, not N."""
        return {oid: self._status_of(oid)
                for oid in payload["object_ids"]}

    async def _handle_wait_objects(self, payload):
        """Push-based wait: park the reply until ``num_ready`` of the
        listed refs are terminal (ready/error/unknown) or the deadline
        fires, then reply with every ref's status.  The park rides the
        memory store's any-change subscription — no per-ref futures, so
        a 1k-ref wait costs one parked reply and O(refs) dict lookups
        per terminal event."""
        oids = payload["object_ids"]
        num_ready = max(1, int(payload.get("num_ready", 1)))
        # Server-side park is bounded: clients re-issue long-polls, so a
        # forgotten wait can never wedge a reply slot for minutes.
        timeout = min(float(payload.get("timeout", 10.0)), 60.0)
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            # Register the wakeup BEFORE snapshotting: a put landing
            # from another thread in between then resolves the already-
            # registered future instead of being missed for a full park.
            change = self.memory.change_future()
            statuses = {oid: self._status_of(oid) for oid in oids}
            n_terminal = sum(1 for s in statuses.values()
                             if s != "pending")
            remaining = deadline - time.monotonic()
            if n_terminal >= min(num_ready, len(oids)) or remaining <= 0:
                self.memory.discard_change_future(change)
                return statuses
            await self.memory.wait_change(remaining, change)

    async def _handle_get_object_info(self, payload):
        """Status + payload size in one round trip — the Data engine's
        byte-budgeted backpressure asks owners for completed block sizes
        (ref: BlockMetadata.size_bytes driving the streaming executor's
        resource manager, data/_internal/execution/resource_manager.py)."""
        entry = self.memory.get_entry(payload["object_id"])
        if entry is None:
            return {"status": "unknown", "size": None}
        if entry[0] == "pending":
            return {"status": "pending", "size": None}
        return {"status": "ready", "size": self._entry_nbytes(entry)}

    async def _handle_get_owned_ref_info(self, payload):
        """Owner-side refcounts for the memory-attribution leak scan
        (`art memory`): for each id, the live Python refs, borrower
        count, and in-flight task-arg pins this owner tracks.  ``None``
        means the owner holds NO reference state for the id — with the
        object still in the cluster directory, that is a leak
        candidate."""
        out = {}
        with self._ref_lock:
            for hexid in payload.get("object_ids", ()):
                oid = ObjectID.from_hex(hexid)
                counts = {"local_refs": self._local_refs.get(oid, 0),
                          "borrows": self._borrows.get(oid, 0),
                          "pins": self._pins.get(oid, 0)}
                if not any(counts.values()) \
                        and not self.memory.contains(oid):
                    out[hexid] = None
                else:
                    out[hexid] = counts
        return out

    @staticmethod
    def _entry_nbytes(entry: tuple) -> int | None:
        kind, value = entry
        if kind == "plasma":
            return value
        try:
            return (len(value) if isinstance(value, (bytes, bytearray,
                                                     memoryview))
                    else None)
        except Exception:  # noqa: BLE001
            return None

    def object_sizes(self, refs) -> list:
        """Best-effort payload size per ref (None when pending/unknown).
        Owned refs answer from the memory store; borrowed refs ask the
        owner.  Never blocks on a pending object."""
        async def _one(ref: ObjectRef):
            if self.memory.is_owned(ref.id):
                entry = self.memory.get_entry(ref.id)
                if entry is None or entry[0] == "pending":
                    return None
                return self._entry_nbytes(entry)
            try:
                info = await self._clients.get(ref.owner_address).call_async(
                    "GetObjectInfo", {"object_id": ref.id}, timeout=5)
            except Exception:  # noqa: BLE001 — owner unreachable: unknown
                return None
            return info.get("size")

        async def _gather():
            return await asyncio.gather(*[_one(r) for r in refs])

        return self._io.run_coro(_gather())

    def _deserialize_payload(self, payload, pin_owner=None) -> Any:
        ser = serialization.SerializedObject.from_payload(
            payload, pin_owner=pin_owner)
        return serialization.deserialize(ser)

    def _make_pin_release(self, oid: ObjectID, token):
        """ReadDone sender for a zero-copy get pin; safe from GC/finalizer
        context on any thread (hops to the io loop)."""
        node = self._node
        loop = self._io.loop

        def _release():
            try:
                loop.call_soon_threadsafe(
                    _spawn,
                    node.oneway_async("ReadDone", {"object_id": oid,
                                                   "pin_token": token}))
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass

        return _release

    async def _pin_renew_loop(self):
        """Heartbeat renewing the daemon-side leases of all live
        zero-copy pins in one batched RPC.  The lease TTL only bounds
        how long a *crashed* reader can wedge an arena slot; live
        readers renew at TTL/3 so a deserialized array held for hours
        stays backed."""
        # This task was spawned from inside a (possibly traced) get()
        # coroutine and inherited its context copy — clear the trace
        # var or every renew heartbeat for the life of the process
        # would record spans attributed to one long-finished request.
        tracing_plane.set_current(None)
        while not self._shutdown:
            ttl = global_config().zero_copy_pin_ttl_s
            await asyncio.sleep(max(0.05, ttl / 3.0))
            pins = [(p.oid, p.token) for p in list(self._live_pins)]
            if not pins:
                continue
            try:
                reply = await self._node.call_async(
                    "RenewPins", {"pins": pins, "ttl": ttl}, timeout=30)
            except Exception:  # noqa: BLE001 — daemon restarting
                continue
            live = {(p.oid, p.token) for p in list(self._live_pins)}
            for oid, token in reply.get("gone", ()):
                if (oid, token) not in live:
                    continue  # value was GC'd mid-heartbeat: benign race
                # The daemon reaped a pin we still hold a value for —
                # its bytes may be recycled under the live view.  This
                # only happens when this process stalls for >TTL (GIL
                # hog, SIGSTOP, swap); make it loud, it's a correctness
                # hazard the user must know about.
                logger.error(
                    "zero-copy pin on %s (token %s) expired at the node "
                    "daemon while the deserialized value is still live; "
                    "its memory may be recycled — copy values you hold "
                    "across long stalls, or raise "
                    "ART_ZERO_COPY_PIN_TTL_S", oid.hex()[:12], token)

    async def _fetch_plasma(self, oid: ObjectID,
                            timeout: float | None) -> tuple:
        """Make the object's payload readable locally.  Returns
        (buffer, pin_owner): arena hits are ZERO-COPY views into shared
        memory, pinned at the daemon until the deserialized value is
        GC'd (ref: plasma-backed read-only arrays — ray.get of a numpy
        array returns a view over shm, not a copy)."""
        payload = {"object_id": oid,
                   "timeout": timeout if timeout else 60.0,
                   "fail_fast_after": global_config().pull_no_holders_grace_s,
                   "pin_ttl": global_config().zero_copy_pin_ttl_s}
        # Inside a sampled trace (caller context rides into this get()
        # coroutine) the daemon records the pull as a child span — the
        # client side is covered by the generic rpc:EnsureLocal span.
        trace = tracing_plane.current_sampled()
        if trace is not None:
            payload["trace"] = trace.to_wire()
        reply = await self._node.call_async("EnsureLocal", payload,
                                            timeout=-1)
        if reply.get("no_holders"):
            raise _AllCopiesLost(oid)
        if reply.get("timeout"):
            raise exceptions.GetTimeoutError(
                f"object {oid.hex()[:12]} not available in time")
        if reply.get("offset") is not None:
            view = self._arena_client.view(
                reply["path"], reply["offset"], reply["size"])
            if reply.get("pinned"):
                token = reply.get("pin_token")
                pin = _ArenaPin(self._make_pin_release(oid, token),
                                oid, token)
                self._live_pins.add(pin)
                if not self._pin_renewer_started:
                    self._pin_renewer_started = True
                    _spawn(self._pin_renew_loop())
                return memoryview(view), pin
            # Unpinned arena window (shouldn't happen): copy out for
            # safety — the slot could be recycled under us.
            return memoryview(bytes(view)), None
        # File-per-object fallback: the mmap stays valid after unlink
        # (POSIX), so plain zero-copy views are already safe.
        return open_object(reply["path"]), None

    async def _get_one(self, ref: ObjectRef, timeout: float | None,
                       raw: bool = False):
        """Resolve one ref to (kind, data): kind ∈ value|error; with
        ``raw`` the data is the stored payload as bytes, not rebuilt.

        The outer loop exists for lineage recovery: after a
        reconstruction round the entry is re-resolved from scratch, so a
        replay that *errored* surfaces the task error instead of chasing
        a plasma object that will never reappear."""
        oid = ref.id
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for _round in range(4):
            remaining = (None if deadline is None
                         else max(0.1, deadline - time.monotonic()))
            if self.memory.is_owned(oid):
                try:
                    kind, value = await self.memory.wait_async(oid, remaining)
                except asyncio.TimeoutError as e:
                    raise exceptions.GetTimeoutError(
                        f"get() timed out on {oid.hex()[:12]}") from e
            else:
                owner = self._clients.get(ref.owner_address)
                kind, value = await owner.call_async(
                    "GetObject", {"object_id": oid, "timeout": remaining},
                    timeout=-1 if remaining is None else remaining + 5)
                if kind == "pending":
                    raise exceptions.GetTimeoutError(
                        f"get() timed out on {oid.hex()[:12]}")
                if kind == "unknown":
                    raise exceptions.ObjectLostError(
                        oid, f"owner {ref.owner_address} does not know "
                        "this object")
            if kind == "plasma":
                try:
                    view, pin_owner = await self._fetch_plasma(
                        oid, remaining)
                except _AllCopiesLost:
                    if not await self._maybe_reconstruct(ref, remaining):
                        raise exceptions.ObjectLostError(
                            oid, "all copies were lost and the object has "
                            "no lineage to reconstruct from") from None
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        raise exceptions.GetTimeoutError(
                            f"get() timed out on {oid.hex()[:12]} during "
                            "reconstruction") from None
                    continue  # re-resolve: replay may have stored an error
                if raw:
                    return ("value", bytes(view))
                return ("value",
                        self._deserialize_payload(view, pin_owner))
            if kind in ("inline", "error"):
                data = (bytes(value) if raw
                        else self._deserialize_payload(value))
                return ("value" if kind == "inline" else "error", data)
            raise AssertionError(f"unexpected entry kind {kind}")
        raise exceptions.ObjectLostError(
            oid, "object kept disappearing despite reconstruction")

    def get(self, refs: Sequence[ObjectRef], timeout: float | None) -> list:
        async def _gather():
            return await asyncio.gather(
                *[self._get_one(r, timeout) for r in refs])

        with self._blocked():
            results = self._io.run_coro(_gather())
        out = []
        for kind, data in results:
            if kind == "error":
                raise data
            out.append(data)
        return out

    def get_payloads(self, refs: Sequence[ObjectRef],
                     timeout: float | None) -> list[tuple[str, bytes]]:
        """The stored payloads of ``refs`` as ("value" | "error", bytes),
        none of them deserialized: what a proxy forwards to its clients
        (util/client/server.py), so a CUDA tensor is never built there."""
        async def _gather():
            return await asyncio.gather(
                *[self._get_one(r, timeout, raw=True) for r in refs])

        with self._blocked():
            return self._io.run_coro(_gather())

    def wait(self, refs, num_returns, timeout, fetch_local):
        """Block until `num_returns` refs are terminal or `timeout`
        elapses (ref: CoreWorker::Wait — a real blocking wait, not a
        status poll; timeout=0 degrades to a poll).

        Owned refs resolve with synchronous memory-store lookups first
        (an all-ready wait over 1k refs costs zero tasks and zero
        RPCs); only still-pending owned refs park on the store.
        Borrowed refs are grouped BY OWNER: one pump per owner drives a
        ``WaitObjects`` long-poll (the owner parks the reply until a
        listed ref turns terminal), falling back to batched
        ``GetObjectStatusBatch`` polling against peers that predate the
        push path — O(owners) RPCs in flight, never O(refs x polls)."""
        # Sync fast path: classify every ref without touching the loop.
        ready_idx: set[int] = set()
        owned_pending: list[tuple[int, ObjectID]] = []
        by_owner: dict[str, list[tuple[int, ObjectID]]] = {}
        for i, ref in enumerate(refs):
            if self.memory.is_owned(ref.id):
                entry = self.memory.get_entry(ref.id)
                if entry is not None and entry[0] != "pending":
                    ready_idx.add(i)
                else:
                    owned_pending.append((i, ref.id))
            else:
                by_owner.setdefault(ref.owner_address, []).append(
                    (i, ref.id))
        if len(ready_idx) >= num_returns:
            ready = [r for i, r in enumerate(refs) if i in ready_idx]
            not_ready = [r for i, r in enumerate(refs)
                         if i not in ready_idx]
            return ready, not_ready

        async def _status_round():
            # Poll semantics (timeout<=0): one batched status round per
            # owner (the RPCs still complete — timeout=0 bounds
            # *waiting*, not the status check itself).
            async def one_owner(owner_addr, items):
                owner = self._clients.get(owner_addr)
                try:
                    statuses = await owner.call_async(
                        "GetObjectStatusBatch",
                        {"object_ids": [oid for _i, oid in items]},
                        timeout=5)
                except Exception:  # noqa: BLE001 — owner gone: ready(err)
                    for i, _oid in items:
                        ready_idx.add(i)
                    return
                for i, oid in items:
                    if statuses.get(oid, "unknown") != "pending":
                        ready_idx.add(i)

            await asyncio.gather(*[one_owner(a, items)
                                   for a, items in by_owner.items()])

        async def _gather():
            if timeout is not None and timeout <= 0:
                await _status_round()
                return
            progress = asyncio.Event()

            def mark(i: int):
                ready_idx.add(i)
                progress.set()

            tasks = [asyncio.ensure_future(
                self._wait_owned(oid, i, mark))
                for i, oid in owned_pending]
            tasks += [asyncio.ensure_future(
                self._wait_owner_pump(owner_addr, items, mark))
                for owner_addr, items in by_owner.items()]
            deadline = (None if timeout is None
                        else self._io.loop.time() + timeout)
            try:
                while len(ready_idx) < num_returns and \
                        not all(t.done() for t in tasks):
                    remaining = (None if deadline is None else
                                 deadline - self._io.loop.time())
                    if remaining is not None and remaining <= 0:
                        return
                    progress.clear()
                    try:
                        await asyncio.wait_for(progress.wait(), remaining)
                    except asyncio.TimeoutError:
                        return
            finally:
                for t in tasks:
                    t.cancel()

        with self._blocked():
            self._io.run_coro(_gather())
        # Snapshot once: cancelled pumps may still mark() on the io
        # thread; reading the live set twice could drop a ref from
        # BOTH lists (lost forever by wait-loop callers).
        done_idx = set(ready_idx)
        ready = [r for i, r in enumerate(refs) if i in done_idx]
        not_ready = [r for i, r in enumerate(refs) if i not in done_idx]
        return ready, not_ready

    async def _wait_owned(self, oid: ObjectID, index: int, mark):
        await self.memory.wait_async(oid)
        mark(index)

    async def _wait_owner_pump(self, owner_addr: str, items, mark):
        """Drive one owner's borrowed refs to terminal: WaitObjects
        long-polls while the owner supports them (server-side park, no
        client sleeps), batched status polling with backoff otherwise.
        An unreachable owner marks everything terminal — the follow-up
        get() surfaces the real error, same as the old per-ref path."""
        owner = self._clients.get(owner_addr)
        # oid -> ALL indices waiting on it (the same borrowed ref may
        # appear several times in one wait call).
        pending: dict = {}
        for i, oid in items:
            pending.setdefault(oid, []).append(i)
        use_push = True
        delay = 0.005
        while pending:
            oids = list(pending)
            try:
                if use_push:
                    try:
                        statuses = await owner.call_async(
                            "WaitObjects",
                            {"object_ids": oids, "num_ready": 1,
                             "timeout": 10.0}, timeout=20)
                    except RpcError as e:
                        if "no route" not in str(e):
                            raise
                        # Owner predates the push path: poll fallback.
                        use_push = False
                        continue
                else:
                    statuses = await owner.call_async(
                        "GetObjectStatusBatch", {"object_ids": oids},
                        timeout=5)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — owner gone: ready(err)
                for indices in pending.values():
                    for i in indices:
                        mark(i)
                return
            for oid, status in statuses.items():
                if status != "pending" and oid in pending:
                    for i in pending.pop(oid):
                        mark(i)
            if not use_push and pending:
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.1)

    def _blocked(self):
        """Tell the node daemon this worker is blocked so its cpu can be
        re-used (deadlock avoidance for nested tasks)."""
        return _BlockedCtx(self)

    # ------------------------------------------------------------ tracing

    def _trace_attach(self, spec: TaskSpec) -> None:
        """Stamp the submission's trace context onto the spec.

        Driver submissions with no ambient context are an INGRESS: a
        root context is minted here (head-sampled — the unsampled mint
        is a coin flip and two random ids, well under the 2 µs budget).
        Worker submissions propagate the executing task's context, so a
        serve request's nested tasks stay in its trace.  Only SAMPLED
        contexts ride the wire — the unsampled common case adds zero
        bytes to the frame and zero work downstream."""
        trace = tracing_plane.current()
        if trace is None:
            if self.role != "driver":
                return
            # Hot-path mint: coin first, ids only on a sampling hit —
            # the unsampled .remote() pays one RNG draw here.
            trace = tracing_plane.maybe_mint()
            if trace is None:
                return
        if not trace.sampled:
            return
        call = trace.child()
        spec.trace_ctx = call.to_wire()
        # Driver-local timing attrs: never pickled (TaskSpec.__reduce__
        # is positional), consumed by _trace_task_reply.
        spec._parent_span = trace.span_id
        spec._t_wall = time.time()
        spec._t_submit = time.perf_counter()

    def _trace_task_reply(self, spec: TaskSpec, error: bool = False):
        """Record the client-side call span when a traced task's reply
        (or terminal error) lands: queue = submit → frame write, wire =
        frame write → reply stored."""
        wire = spec.trace_ctx
        t0 = getattr(spec, "_t_submit", None)
        if wire is None or t0 is None:
            return
        now = time.perf_counter()
        t_send = getattr(spec, "_t_send", now)
        stages = {"queue": max(0.0, t_send - t0),
                  "wire": max(0.0, now - t_send)}
        tracing_plane.record_span(
            wire, f"call:{spec.function_name}",
            ts=getattr(spec, "_t_wall", time.time()), dur_s=now - t0,
            stages=stages,
            attrs={"task_id": spec.task_id.hex(),
                   "attempt": spec.attempt},
            error=error, span_id=wire[1],
            parent_id=getattr(spec, "_parent_span", ""),
            service="submitter")
        tracing_plane.record_rpc(
            "PushTask", {"client_queue": stages["queue"],
                         "client_wire": stages["wire"]}, wire[0])

    # ------------------------------------------------------------ tasks

    def submit_task(self, remote_function, args, kwargs, options: TaskOptions):
        fn_key = self.export(remote_function.function, "fn")
        task_id = TaskID.for_normal_task(self.job_id)
        streaming = options.num_returns == "streaming"
        num_returns = -1 if streaming else options.num_returns
        return_refs = []
        if streaming:
            self._register_stream(task_id)
        else:
            for i in range(num_returns):
                oid = ObjectID.for_task_return(task_id, i)
                self.memory.mark_pending(oid)
                return_refs.append(
                    ObjectRef(oid, owner_address=self.address))

        args_payload, pinned = self._pack_args(args, kwargs)
        cfg = global_config()
        spec = TaskSpec(
            task_id=task_id,
            function_id=fn_key,
            function_name=remote_function.function_name,
            args_payload=args_payload,
            num_returns=num_returns,
            owner_address=self.address,
            resources=options.resource_demand(),
            # Streaming tasks never retry: replaying would re-emit items
            # the consumer already observed (ref: generator tasks are
            # non-retriable by default).
            max_retries=(0 if streaming else
                         (options.max_retries
                          if options.max_retries is not None
                          else cfg.task_max_retries_default)),
            retry_exceptions=options.retry_exceptions,
            placement_group_id=(options.placement_group.id
                                if options.placement_group is not None
                                else None),
            placement_group_bundle_index=max(
                options.placement_group_bundle_index, 0),
            runtime_env=self._package_runtime_env(options.runtime_env),
            label_selector=options.label_selector,
            scheduling_strategy=strategy_wire(
                options.scheduling_strategy),
        )
        self._trace_attach(spec)
        if cfg.enable_insight:
            from ant_ray_tpu_torch.util import insight  # noqa: PLC0415

            insight.record_call_submit(spec.function_name,
                                       task_id.hex(), self.role)
        if cfg.enable_task_events:
            task_events.record(task_id.hex(), spec.function_name,
                               "submitted")
        self._post_submit(self._enqueue_task, spec, pinned, 0)
        if streaming:
            from ant_ray_tpu_torch.object_ref import ObjectRefGenerator  # noqa: PLC0415

            return ObjectRefGenerator(task_id, self)
        return return_refs[0] if num_returns == 1 else return_refs

    def _pack_args(self, args, kwargs) -> tuple[bytes, list]:
        """Serialize task args; large blobs are promoted to plasma so the
        control-plane RPC frame stays small (ref behavior:
        max_direct_call_object_size).  Returns (wire payload, refs pinned
        for the task's lifetime — unpinned by the caller on completion)."""
        if not args and not kwargs:
            return _EMPTY_ARGS_PAYLOAD, []
        ser = _serialized_args(args, kwargs)
        if ser.payload_nbytes() <= global_config().max_inline_object_size:
            if ser.contained_refs:
                self._pin(ser.contained_refs)
            return ser.to_payload(), list(ser.contained_refs)
        # put_serialized() pins the contained refs for the plasma object's
        # lifetime; the task pins only the promoted object itself.
        args_ref = self.put_serialized(ser)
        self._pin([args_ref])
        wrapper = serialization.serialize(PromotedArgs(args_ref))
        return wrapper.to_payload(), [args_ref]

    def _package_runtime_env(self, runtime_env: dict | None):
        """Stage a runtime env into GCS KV (cached per content)."""
        if not runtime_env:
            return None
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        cache_key = renv.content_fingerprint(runtime_env)
        wire = self._renv_cache.get(cache_key)
        if wire is None:
            wire = renv.package(
                runtime_env,
                lambda key, blob: self._gcs.call(
                    "KVPut", {"key": key, "value": blob,
                              "overwrite": False}, retries=3))
            self._renv_cache[cache_key] = wire
        return wire

    def _post_submit(self, fn, *args) -> None:
        """Run fn(*args) on the io loop, coalescing wakeups across a
        burst of submissions from app threads.  The flag is cleared
        before draining, so an append racing the drain at worst costs a
        redundant (harmless) wakeup, never a lost one."""
        self._submit_inbox.append((fn, args))
        if not self._inbox_scheduled:
            self._inbox_scheduled = True
            self._io.loop.call_soon_threadsafe(self._drain_submit_inbox)

    def _drain_submit_inbox(self) -> None:
        self._inbox_scheduled = False
        # One drain callback serves a whole burst of submissions from
        # DIFFERENT app threads, but call_soon_threadsafe copied only
        # the scheduling thread's context — clear the trace contextvar
        # so io-loop machinery (lease acquisition, senders) never
        # attributes its RPCs to whichever thread happened to schedule
        # the wakeup.  Per-task attribution rides spec.trace_ctx.
        tracing_plane.set_current(None)
        inbox = self._submit_inbox
        while inbox:
            fn, args = inbox.popleft()
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — never kill the drainer
                logger.exception("submission handling failed")

    # ----------------------------------------- scheduling-key submission
    # (ref: NormalTaskSubmitter, task_submission/normal_task_submitter.cc:185
    #  — worker leases are keyed by the task's scheduling class and reused
    #  across queued tasks, with pipelined pushes hiding the RPC round
    #  trip; without this every task pays lease+push+return round trips.)

    def _sched_key(self, spec: TaskSpec) -> tuple:
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        strategy = spec.scheduling_strategy
        return (
            tuple(sorted(spec.resources.items())),
            renv.env_key(spec.runtime_env),
            tuple(sorted((spec.label_selector or {}).items())),
            (spec.placement_group_id, spec.placement_group_bundle_index)
            if spec.placement_group_id is not None else None,
            (tuple(sorted(strategy.items()))
             if isinstance(strategy, dict) else strategy),
        )

    def _enqueue_task(self, spec: TaskSpec, pinned, attempt: int):
        """Queue a task under its scheduling key (io-loop only)."""
        key = self._sched_key(spec)
        state = self._sched_states.get(key)
        if state is None:
            state = _SchedKeyState(
                resources=spec.resources,
                runtime_env=spec.runtime_env,
                label_selector=spec.label_selector,
                pg=((spec.placement_group_id,
                     spec.placement_group_bundle_index)
                    if spec.placement_group_id is not None else None),
                strategy=spec.scheduling_strategy)
            self._sched_states[key] = state
        state.queue.append((spec, pinned, attempt))
        state.wakeup.set()
        self._maybe_acquire(key, state)

    def _maybe_acquire(self, key: tuple, state: _SchedKeyState):
        # Leases scale with queued tasks that IDLE capacity can't absorb:
        # a worker mid-task is not capacity, so a task submitted while
        # the key's only worker executes gets its own lease instead of
        # serializing behind it (ref: NormalTaskSubmitter grows pending
        # lease requests with the task queue, not the lease count).
        # A queue surplus is requested as BATCHED leases: one LeaseWorker
        # round trip asks for up to lease_batch_size workers (acquiring
        # counts requested WORKERS, and the cap bounds them the same
        # way it bounded one-per-request leases).
        cfg = global_config()
        cap = cfg.max_pending_lease_requests
        batch = max(1, cfg.lease_batch_size)
        while (state.acquiring < cap
               and (state.acquiring + max(0, state.workers - state.busy)
                    < len(state.queue))):
            deficit = len(state.queue) - state.acquiring \
                - max(0, state.workers - state.busy)
            want = max(1, min(batch, deficit, cap - state.acquiring))
            state.acquiring += want
            # _spawn, not bare ensure_future: the lease round trip and
            # the grant drains suspend on socket writes, and a GC'd
            # task would leak the lease (workers count never undone).
            _spawn(self._acquire_worker(key, state, want))

    async def _acquire_worker(self, key: tuple, state: _SchedKeyState,
                              count: int = 1):
        try:
            grants = await self._lease_for_state(state, count)
        except Exception as e:  # noqa: BLE001 — infeasible / saturated
            state.acquiring -= count
            # Only a key with no serving capacity at all fails its queue:
            # with live workers the queue still drains through them.
            if state.workers == 0 and state.acquiring == 0:
                while state.queue:
                    spec, pinned, _attempt = state.queue.popleft()
                    # Per-task error naming: the shared scheduling-key
                    # failure must still say which remote call it sank.
                    self._store_error(spec, exceptions.ArtError(
                        f"task {spec.function_name}: {e}"))
                    self._unpin(pinned)
            return
        state.acquiring -= count
        # Count every grant as a worker BEFORE re-examining the queue:
        # _maybe_acquire reads workers-busy as idle capacity, and the
        # grants below are exactly that until their drains start.
        state.workers += len(grants)
        if len(grants) < count:
            # Under-granted batch (the daemon had fewer idle workers
            # than asked): re-request the unfilled deficit NOW — the
            # pre-batching protocol kept up to cap CONCURRENT lease
            # requests alive, and a crash-recovery burst must not
            # serialize behind this one grant finishing its drain.
            self._maybe_acquire(key, state)
        # Extra grants (batched lease: one daemon round trip served a
        # queue surplus) drain concurrently; grants the queue has
        # already drained past are returned to the daemon immediately.
        for extra in grants[1:]:
            _spawn(self._run_granted(key, state, *extra))
        await self._run_granted(key, state, *grants[0])

    async def _run_granted(self, key: tuple, state: _SchedKeyState,
                           node, worker_addr: str, worker_id):
        """Drain the queue through one granted lease, then return it.
        ``state.workers`` was incremented by the caller (synchronously
        with the grant, so _maybe_acquire never over-leases)."""
        try:
            if state.queue:
                await self._worker_drain(state, worker_addr)
        finally:
            state.workers -= 1
            try:
                await node.call_async(
                    "ReturnWorker", {"worker_id": worker_id}, timeout=10)
            except Exception:  # noqa: BLE001
                pass
            if state.queue:
                self._maybe_acquire(key, state)
            elif (state.workers == 0 and state.acquiring == 0
                  and self._sched_states.get(key) is state):
                del self._sched_states[key]

    async def _lease_for_state(self, state: _SchedKeyState,
                               count: int = 1):
        """Acquire worker leases for a scheduling key, following
        spillback redirects; returns a non-empty list of
        (node_client, worker_addr, worker_id) grants.  ``count > 1``
        asks the serving daemon for a batch in the same round trip
        (payload ``count`` — ignored by pre-batching daemons, which
        reply with the classic single grant).  Raises on terminal
        infeasibility/saturation."""
        lease_payload = {"resources": state.resources,
                         "runtime_env": state.runtime_env,
                         "job_id": self.job_id,
                         # Lessee identity: the daemon reclaims this
                         # lease if the owner dies before ReturnWorker.
                         "owner": self.address,
                         "label_selector": state.label_selector,
                         "strategy": state.strategy}
        if count > 1:
            lease_payload["count"] = count
        if state.queue:
            # Head task's plasma deps ride the lease so the serving node
            # can pull them before the grant (ref:
            # lease_dependency_manager.h pull-before-grant; later tasks
            # pipelined onto the same lease fetch at execution).  ONLY
            # refs known to be plasma-backed qualify: an inline object
            # has no cluster locations, so the daemon's pull would poll
            # an empty holder list for its whole budget and stall every
            # lease of the key (pending and borrowed refs are likewise
            # excluded — their storage class is unknown here).
            deps = [r.id for r in state.queue[0][1]
                    if (entry := self.memory.get_entry(r.id)) is not None
                    and entry[0] == "plasma"]
            if deps:
                lease_payload["deps"] = deps
            # The head task's trace rides the lease so the serving
            # daemon records the grant as a child span of the request.
            head_trace = state.queue[0][0].trace_ctx
            if head_trace is not None:
                lease_payload["trace"] = head_trace
        if state.pg is not None:
            node = await self._resolve_bundle_node(*state.pg)
            lease_payload["pg"] = state.pg
        else:
            node = self._node
        infeasible_deadline: float | None = None
        deadline = time.monotonic() + global_config().lease_retry_deadline_s
        hops = 0
        conn_failures = 0
        while time.monotonic() < deadline:
            hops += 1
            if hops > 4:
                await asyncio.sleep(min(0.05 * (hops - 4), 0.5))
            try:
                reply = await node.call_async(
                    "LeaseWorker", lease_payload, timeout=-1)
            except RpcConnectionError:
                # Transient daemon unavailability (restart, chaos, net
                # blip) must not be terminal for the whole queue — back
                # off and retry within the deadline, falling back to the
                # home node if a spillback target died.
                conn_failures += 1
                self._clients.invalidate(node.address)
                node = (self._node if state.pg is None
                        else await self._resolve_bundle_node(*state.pg))
                # Back on the home node the strategy must re-route from
                # scratch — a stale routed flag would let a hard pin be
                # served wherever we fell back to.
                lease_payload.pop("routed", None)
                await asyncio.sleep(min(0.1 * conn_failures, 2.0))
                continue
            if "granted" in reply:
                grants = [(node, reply["granted"], reply["worker_id"])]
                grants.extend(
                    (node, e["granted"], e["worker_id"])
                    for e in reply.get("extra", ()))
                return grants
            if "spill" in reply:
                node = self._clients.get(reply["spill"])
                if reply.get("routed"):
                    # A strategy redirect already picked this target:
                    # the next daemon serves it instead of re-running
                    # the picker (which would ping-pong).
                    lease_payload = dict(lease_payload, routed=True)
            elif "infeasible" in reply:
                # With a live autoscaler the recorded demand may
                # provision a node — wait and retry instead of failing
                # (ref: infeasible tasks queue until the autoscaler
                # satisfies them).  Without one, fail fast.
                if await self._autoscaling_enabled():
                    if infeasible_deadline is None:
                        infeasible_deadline = time.monotonic() + \
                            global_config().infeasible_wait_s
                        deadline = max(deadline, infeasible_deadline + 1)
                    if time.monotonic() < infeasible_deadline:
                        await asyncio.sleep(1.0)
                        continue
                reason = reply.get("reason") or (
                    f"requests resources {state.resources} that no node "
                    "can ever satisfy")
                raise exceptions.ArtError(f"task is infeasible: {reason}")
            else:
                raise exceptions.ArtError(f"bad lease reply {reply}")
        raise exceptions.ArtError(
            f"tasks requesting {state.resources} could not be scheduled "
            f"within {global_config().lease_retry_deadline_s:.0f}s "
            f"({hops} spillback hops) — cluster saturated or demand "
            "unsatisfiable")

    async def _worker_drain(self, state: _SchedKeyState, worker_addr: str):
        """Feed queued tasks of one scheduling key to one leased worker,
        keeping up to pipeline_depth pushes in flight; the lease lingers
        briefly on an empty queue so sync call→get loops reuse it."""
        cfg = global_config()
        client = self._clients.get(worker_addr)
        depth = max(1, cfg.task_push_pipeline_depth)
        linger = cfg.task_lease_linger_s
        marked_busy = False

        def _set_busy(value: bool):
            nonlocal marked_busy
            if value and not marked_busy:
                marked_busy = True
                state.busy += 1
            elif not value and marked_busy:
                marked_busy = False
                state.busy -= 1

        try:
            await self._worker_drain_loop(
                state, client, depth, linger, _set_busy)
        finally:
            _set_busy(False)

    async def _worker_drain_loop(self, state, client, depth, linger,
                                 _set_busy):
        inflight: deque = deque()
        dead: Exception | None = None
        while True:
            # Pipeline beyond one in-flight task only for queue surplus
            # that pending lease acquisitions could not absorb anyway —
            # greedily batching into one worker would serialize tasks
            # that parallel workers should run.
            while (dead is None and state.queue and len(inflight) < depth
                   and (not inflight
                        or len(state.queue) > state.acquiring)):
                spec, pinned, attempt = state.queue.popleft()
                spec.attempt = attempt
                if spec.trace_ctx is not None:
                    spec._t_send = time.perf_counter()
                fut = client.try_send_deferred("PushTask", spec)
                if fut is None:
                    try:
                        fut = await client.send_request("PushTask", spec,
                                                        defer=True)
                    except (RpcConnectionError, OSError) as e:
                        dead = e
                        state.queue.appendleft((spec, pinned, attempt))
                        # Frames deferred earlier this burst were never
                        # shipped — fail their futures (reaped below as
                        # retries) rather than leaving them to replay.
                        client.discard_deferred()
                        break
                inflight.append((spec, pinned, attempt, fut))
            # A worker with pushes in flight is busy — not idle capacity
            # — so _maybe_acquire leases more workers for queue surplus.
            _set_busy(bool(inflight))
            if dead is None and inflight:
                try:
                    await client.flush_deferred()
                except (RpcConnectionError, OSError) as e:
                    dead = e
            if inflight:
                spec, pinned, attempt, fut = inflight.popleft()
                try:
                    reply = await fut
                    self._store_returns(spec, reply["returns"])
                    self._unpin(pinned)
                except (RpcConnectionError, asyncio.CancelledError,
                        exceptions.WorkerCrashedError) as e:
                    dead = (e if isinstance(e, Exception)
                            else exceptions.WorkerCrashedError(repr(e)))
                    self._retry_or_fail(spec, pinned, attempt, dead)
                except exceptions.ArtError as e:
                    self._store_error(spec, e)
                    self._unpin(pinned)
                except Exception as e:  # noqa: BLE001 — never lose a task
                    logger.exception("internal error running task %s",
                                     spec.function_name)
                    self._store_error(spec, exceptions.ArtError(repr(e)))
                    self._unpin(pinned)
                continue
            if dead is not None:
                return
            if state.queue:
                continue
            # Empty queue, nothing in flight: linger for the next task.
            state.wakeup.clear()
            if not state.queue:  # re-check after clear (enqueue races set)
                try:
                    await asyncio.wait_for(state.wakeup.wait(), linger)
                except asyncio.TimeoutError:
                    return
            if not state.queue:
                return

    def _retry_or_fail(self, spec: TaskSpec, pinned, attempt: int,
                       err: Exception):
        """A pushed task's worker died: retry on a fresh lease (bounded
        by max_retries) or surface the error."""
        if attempt < spec.max_retries:
            logger.warning("task %s attempt %d/%d failed: %s",
                           spec.function_name, attempt + 1,
                           spec.max_retries + 1, err)
            # Brief backoff so daemons reap dead workers before the
            # retry leases again (ref: NormalTaskSubmitter retry delays).
            self._io.loop.call_later(
                min(0.05 * (attempt + 1), 0.5),
                self._enqueue_task, spec, pinned, attempt + 1)
        else:
            self._store_error(spec, exceptions.WorkerCrashedError(
                f"task {spec.function_name} failed after "
                f"{spec.max_retries + 1} attempts: {err}"))
            self._unpin(pinned)

    async def _resolve_bundle_node(self, pg_id, bundle_index: int):
        """Wait for the placement group, return the bundle's node client.
        Bundle → node never changes after creation, so resolution is
        cached (no per-task GCS round-trip on the hot path)."""
        cached = self._pg_bundle_cache.get(pg_id)
        if cached is None:
            for _ in range(240):
                state = await self._gcs.call_async(
                    "GetPlacementGroup", {"pg_id": pg_id}, timeout=10)
                if state is None:
                    raise exceptions.ArtError("placement group was removed")
                if state["state"] == "FAILED":
                    raise exceptions.ArtError(
                        f"placement group failed: {state.get('reason', '')}")
                if state["state"] == "CREATED":
                    cached = state["bundle_nodes"]
                    self._pg_bundle_cache[pg_id] = cached
                    break
                await asyncio.sleep(0.25)
            else:
                raise exceptions.ArtError(
                    "placement group never became ready")
        if not 0 <= bundle_index < len(cached):
            raise exceptions.ArtError(
                f"bundle index {bundle_index} out of range for group with "
                f"{len(cached)} bundles")
        return self._clients.get(cached[bundle_index])

    async def _autoscaling_enabled(self) -> bool:
        """Cached (10s) GCS check for a live autoscaler heartbeat."""
        now = time.monotonic()
        cached = getattr(self, "_autoscaling_cache", None)
        if cached is not None and now - cached[1] < 10.0:
            return cached[0]
        try:
            enabled = bool(await self._gcs.call_async(
                "AutoscalingEnabled", {}, timeout=5))
        except Exception:  # noqa: BLE001 — GCS briefly away: fail fast
            enabled = False
        self._autoscaling_cache = (enabled, now)
        return enabled

    async def _lease_and_push(self, spec: TaskSpec) -> dict:
        """Lease a worker (following spillback redirects), push the task,
        return the worker reply (ref: NormalTaskSubmitter::SubmitTask)."""
        lease_payload = {"resources": spec.resources,
                         "runtime_env": spec.runtime_env,
                         "job_id": self.job_id,
                         "label_selector": spec.label_selector,
                         "strategy": spec.scheduling_strategy}
        if spec.placement_group_id is not None:
            node = await self._resolve_bundle_node(
                spec.placement_group_id, spec.placement_group_bundle_index)
            lease_payload["pg"] = (spec.placement_group_id,
                                   spec.placement_group_bundle_index)
        else:
            node = self._node
        infeasible_deadline: float | None = None
        # Spillback is redirect-following, not a retry budget: on a
        # saturated cluster two busy nodes legitimately bounce a lease
        # between each other until capacity frees (the reference's
        # submitter follows retry_at_raylet_address unboundedly,
        # normal_task_submitter.cc:435).  Bound by TIME, not hops, and
        # back off as the bounce count grows so the ping-pong doesn't
        # melt the control plane.
        deadline = time.monotonic() + global_config().lease_retry_deadline_s
        hops = 0
        while time.monotonic() < deadline:
            hops += 1
            if hops > 4:
                await asyncio.sleep(min(0.05 * (hops - 4), 0.5))
            reply = await node.call_async(
                "LeaseWorker", lease_payload, timeout=-1)
            if "granted" in reply:
                worker_addr = reply["granted"]
                worker_id = reply["worker_id"]
                worker = self._clients.get(worker_addr)
                try:
                    return await worker.call_async("PushTask", spec,
                                                   timeout=-1)
                finally:
                    try:
                        await node.call_async(
                            "ReturnWorker", {"worker_id": worker_id},
                            timeout=10)
                    except Exception:  # noqa: BLE001
                        pass
            elif "spill" in reply:
                node = self._clients.get(reply["spill"])
                if reply.get("routed"):
                    lease_payload = dict(lease_payload, routed=True)
            elif "infeasible" in reply:
                # With a live autoscaler the recorded demand may
                # provision a node — wait and retry instead of failing
                # (ref: infeasible tasks queue until the autoscaler
                # satisfies them).  Without one, fail fast as before.
                if await self._autoscaling_enabled():
                    if infeasible_deadline is None:
                        infeasible_deadline = time.monotonic() + \
                            global_config().infeasible_wait_s
                        # Provisioning may take longer than the lease
                        # deadline — an infeasible wait extends it.
                        deadline = max(deadline, infeasible_deadline + 1)
                    if time.monotonic() < infeasible_deadline:
                        await asyncio.sleep(1.0)
                        continue
                reason = reply.get("reason") or (
                    f"requests resources {spec.resources} that no node "
                    "can ever satisfy")
                raise exceptions.ArtError(
                    f"task {spec.function_name} is infeasible: {reason}")
            else:
                raise exceptions.ArtError(f"bad lease reply {reply}")
        raise exceptions.ArtError(
            f"task {spec.function_name} could not be scheduled within "
            f"{global_config().lease_retry_deadline_s:.0f}s "
            f"({hops} spillback hops) — cluster saturated or demand "
            f"unsatisfiable")

    # --------------------------------------------------- streaming returns

    async def _handle_stream_item(self, payload):
        """A streaming task produced its next item (worker → owner,
        ordered oneway on one connection)."""
        task_id = payload["task_id"]
        oid = ObjectID.for_task_return(task_id, payload["index"])
        if task_id in self._released_streams:
            # The consumer abandoned this stream; drop the item instead
            # of storing it forever (plasma copies are freed explicitly).
            if payload["kind"] == "plasma":
                self._send_oneway(self.gcs_address, "FreeObject",
                                  {"object_id": oid})
            return True
        self.memory.put(oid, payload["kind"], payload["data"])
        state = self._streams.get(task_id)
        if state is not None:
            with state.cond:
                state.received = max(state.received, payload["index"] + 1)
                state.cond.notify_all()
        return True

    def _register_stream(self, task_id: TaskID) -> None:
        self._streams[task_id] = _StreamState()

    def _finish_stream(self, task_id: TaskID, total: int,
                       error: Exception | None) -> None:
        state = self._streams.get(task_id)
        if state is None:
            return
        with state.cond:
            state.total = total
            state.error = error
            state.cond.notify_all()

    def stream_next(self, task_id: TaskID, index: int,
                    timeout: float | None):
        """Block until return #index exists (→ its ObjectRef), the stream
        ends (→ None), or a mid-stream failure surfaces (→ raises).
        A missing stream (already fully consumed / released) reads as
        exhausted, so re-iterating a finished generator raises
        StopIteration like any other iterator."""
        state = self._streams.get(task_id)
        if state is None:
            return None
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with state.cond:
            while True:
                # Items already received stream out even after a failure —
                # the error surfaces at the point production stopped.
                if index < state.received:
                    return ObjectRef(
                        ObjectID.for_task_return(task_id, index),
                        owner_address=self.address)
                if state.total is not None and index >= state.total:
                    # End marker seen AND index past it.  Items travel on
                    # a different connection than the marker, so wait for
                    # stragglers (received < total) instead of dropping
                    # them.
                    if state.error is not None:
                        self._streams.pop(task_id, None)
                        raise state.error
                    if state.received >= state.total:
                        self._streams.pop(task_id, None)
                        return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise exceptions.GetTimeoutError(
                        f"stream item {index} of "
                        f"{task_id.hex()[:12]} not ready in time")
                state.cond.wait(remaining if remaining is not None
                                else 1.0)

    def release_stream(self, task_id: TaskID, consumed: int) -> None:
        """Drop an abandoned stream's state and free the items the
        consumer never took (called from ObjectRefGenerator.__del__ —
        without it, a half-read stream leaks its tail forever).  The
        task id is remembered so items still in flight from the
        still-running producer are dropped on arrival."""
        state = self._streams.pop(task_id, None)
        if state is None:
            return
        self._released_streams[task_id] = True
        while len(self._released_streams) > 1024:  # bounded memory
            self._released_streams.pop(
                next(iter(self._released_streams)))
        with state.cond:
            received = state.received
        with self._ref_lock:
            for i in range(consumed, received):
                oid = ObjectID.for_task_return(task_id, i)
                if self.memory.is_owned(oid):
                    self._maybe_free_locked(oid)

    def _store_returns(self, spec: TaskSpec, returns: list):
        if spec.trace_ctx is not None:
            failed = any(
                kind == "error"
                or (kind == "stream_end" and data[1] is not None)
                for kind, data in returns)
            self._trace_task_reply(spec, error=failed)
        if spec.num_returns == -1:  # streaming: end-of-stream marker
            kind, data = returns[0]
            assert kind == "stream_end", kind
            count, err_payload = data
            error = (self._deserialize_payload(err_payload)
                     if err_payload is not None else None)
            self._finish_stream(spec.task_id, count, error)
            return
        for i, (kind, data) in enumerate(returns):
            oid = ObjectID.for_task_return(spec.task_id, i)
            self.memory.put(oid, kind, data)
            # Normal-task plasma returns are reconstructible by lineage;
            # actor-task replay is unsafe (state mutations) so actor
            # returns (function_id == "") are excluded, as are tasks the
            # user marked non-retryable (at-most-once side effects).
            if kind == "plasma" and spec.function_id and spec.max_retries:
                self._lineage[oid] = spec

    # --------------------------------------------------- device objects
    # (ref capability: GPUObjectStore per actor + tensor transports,
    #  experimental/gpu_object_manager/ — here the transport is
    #  card→host copy + RPC; see experimental/device_objects.py)

    async def _handle_device_tensor_fetch(self, payload):
        """The dma transport's holder side: the tensor's bytes, copied
        to the host off the io loop, as one raw reply frame (no pickle
        copy of the payload; the consumer rebuilds dtype and shape from
        the object's metadata, so bfloat16 crosses unchanged)."""
        tensor = self._device_objects.get(payload["token"])
        if tensor is None:
            return None
        from ant_ray_tpu_torch.experimental.tensor_transport import (  # noqa: PLC0415
            host_bytes,
        )

        data = await asyncio.get_running_loop().run_in_executor(
            None, host_bytes, tensor)
        return RawReply(data)

    async def _handle_device_tensor_free(self, payload):
        self._device_objects.pop(payload["token"], None)
        return True

    async def _handle_device_tensor_send_via(self, payload):
        """Collective-transport trigger: push the sharded tensor's
        shards to the requesting consumer over the collective group
        (ref capability: collective_tensor_transport's sender side).
        Replies immediately with whether the token exists — the reply
        is the consumer's go/no-go BEFORE it parks in recv (a missing
        token must surface as ObjectLost, not a recv hang); the sends
        themselves run in an executor, blocking until the consumer's
        recvs match."""
        tensor = self._device_objects.get(payload["token"])
        if tensor is None:
            return False
        from ant_ray_tpu_torch.experimental.tensor_transport import (  # noqa: PLC0415
            send_shards,
        )

        asyncio.get_running_loop().run_in_executor(
            None, send_shards, tensor, payload["dst_rank"],
            payload["group"])
        return True

    def _fetch_device_tensor(self, holder: str, token: str,
                             timeout: float | None):
        client = self._clients.get(holder)
        with self._blocked():
            return self._io.run_coro(client.call_async(
                "DeviceTensorFetch", {"token": token},
                timeout=-1 if timeout is None else timeout))

    def pin_for_grace(self, ref: ObjectRef, grace_s: float = 60.0):
        """Hold an extra pin on an owned object for a grace window —
        covers the gap between returning a ref from a task and the
        consumer's BorrowAdd registration, after which normal
        refcounting governs."""
        oid = ref.id
        with self._ref_lock:
            self._pins[oid] = self._pins.get(oid, 0) + 1

        def _expire():
            with self._ref_lock:
                count = self._pins.get(oid, 0) - 1
                if count <= 0:
                    self._pins.pop(oid, None)
                else:
                    self._pins[oid] = count
                if self.memory.is_owned(oid):
                    self._maybe_free_locked(oid)

        self._io.loop.call_soon_threadsafe(
            self._io.loop.call_later, grace_s, _expire)

    # ------------------------------------------------- lineage recovery

    async def _maybe_reconstruct(self, ref: ObjectRef,
                                 timeout: float | None = None) -> bool:
        """Recover a lost plasma object: owners re-execute the producing
        task; borrowers ask the owner to (bounded by the caller's
        remaining get() timeout)."""
        oid = ref.id
        if self.memory.is_owned(oid):
            return await self._reconstruct_owned(oid)
        try:
            owner = self._clients.get(ref.owner_address)
            return bool(await owner.call_async(
                "ReconstructObject", {"object_id": oid},
                timeout=-1 if timeout is None else timeout + 5))
        except Exception as e:  # noqa: BLE001 — owner gone: unrecoverable
            logger.warning("owner reconstruction RPC for %s failed: %s",
                           oid.hex()[:8], e)
            return False

    async def _handle_reconstruct_object(self, payload):
        oid = payload["object_id"]
        if not self.memory.is_owned(oid):
            return False
        return await self._reconstruct_owned(oid)

    async def _reconstruct_owned(self, oid: ObjectID) -> bool:
        spec = self._lineage.get(oid)
        if spec is None:
            return False
        fut = self._reconstructions.get(spec.task_id)
        if fut is None:
            # One re-execution covers all of the task's return objects;
            # concurrent waiters share it.
            fut = asyncio.ensure_future(self._reexecute_for_lineage(spec))
            self._reconstructions[spec.task_id] = fut
            fut.add_done_callback(
                lambda _f: self._reconstructions.pop(spec.task_id, None))
        try:
            await asyncio.shield(fut)
            return True
        except Exception as e:  # noqa: BLE001
            logger.warning("lineage re-execution of %s failed: %s",
                           spec.function_name, e)
            return False

    async def _reexecute_for_lineage(self, spec: TaskSpec):
        logger.info("reconstructing lost outputs of %s by lineage "
                    "re-execution", spec.function_name)
        last: Exception | None = None
        for _attempt in range(3):
            try:
                reply = await self._lease_and_push(spec)
                self._store_returns(spec, reply["returns"])
                return
            except (RpcConnectionError, exceptions.WorkerCrashedError) as e:
                last = e
        raise exceptions.ObjectLostError(
            ObjectID.for_task_return(spec.task_id, 0),
            f"lineage re-execution kept failing: {last}")

    def _store_error(self, spec: TaskSpec, err: Exception):
        if spec.trace_ctx is not None:
            self._trace_task_reply(spec, error=True)
        if spec.num_returns == -1:  # streaming: fail the stream
            state = self._streams.get(spec.task_id)
            self._finish_stream(
                spec.task_id,
                state.received if state is not None else 0, err)
            return
        payload = serialization.serialize_error(err).to_payload()
        for i in range(spec.num_returns):
            oid = ObjectID.for_task_return(spec.task_id, i)
            self.memory.put(oid, "error", payload)

    # ------------------------------------------------------------ actors

    def create_actor(self, actor_class, args, kwargs, options: ActorOptions):
        from ant_ray_tpu_torch.actor import ActorHandle  # noqa: PLC0415

        declared = set(options.concurrency_groups or ())
        undeclared = {g for g in actor_class.method_concurrency_groups()
                      .values() if g not in declared}
        if undeclared:
            raise ValueError(
                f"Methods of {actor_class._class_name} use concurrency "
                f"group(s) {sorted(undeclared)} not declared in "
                f"concurrency_groups={sorted(declared)} "
                "(ref: @ray.remote(concurrency_groups=...))")
        cls_key = self.export(actor_class.cls, "cls")
        actor_id = ActorID.of(self.job_id)
        ser = _serialized_args(args, kwargs)
        args_payload = ser.to_payload()
        # Large ctor args travel through plasma like task args do —
        # except for detached actors, whose restarts must outlive this
        # owner process, so their args stay embedded in the GCS spec.
        promote = (options.lifetime != "detached"
                   and len(args_payload)
                   > global_config().max_inline_object_size)
        if promote:
            args_ref = self.put_serialized(ser)
            self._pin([args_ref])
            with self._ref_lock:
                self._actor_ctor_pins[actor_id] = [args_ref]
            args_payload = serialization.serialize(
                PromotedArgs(args_ref)).to_payload()
        elif ser.contained_refs:
            # Constructor args must survive actor restarts; released when
            # the actor is killed or observed permanently dead.
            self._pin(ser.contained_refs)
            with self._ref_lock:
                self._actor_ctor_pins[actor_id] = list(ser.contained_refs)
        cfg = global_config()
        spec = ActorSpec(
            actor_id=actor_id,
            class_id=cls_key,
            class_name=actor_class._class_name,
            args_payload=args_payload,
            owner_address=self.address,
            resources=options.resource_demand(),
            placement_resources=options.placement_demand(),
            max_restarts=(options.max_restarts
                          if options.max_restarts is not None
                          else cfg.actor_max_restarts_default),
            max_concurrency=options.max_concurrency,
            concurrency_groups=options.concurrency_groups,
            name=options.name,
            namespace=options.namespace or self.namespace,
            lifetime=options.lifetime,
            job_id=self.job_id,
            placement_group_id=(options.placement_group.id
                                if options.placement_group is not None
                                else None),
            placement_group_bundle_index=max(
                options.placement_group_bundle_index, 0),
            runtime_env=self._package_runtime_env(options.runtime_env),
            label_selector=options.label_selector,
            scheduling_strategy=strategy_wire(
                options.scheduling_strategy),
        )
        reply = self._gcs.call("CreateActor", spec, retries=3)
        if "error" in reply:
            if options.get_if_exists and options.name:
                return self.get_actor(options.name, options.namespace)
            raise ValueError(reply["error"])
        meta = {
            "method_names": actor_class.method_names(),
            "method_num_returns": actor_class.method_num_returns(),
            "max_task_retries": options.max_task_retries,
            "method_concurrency_groups":
                actor_class.method_concurrency_groups(),
        }
        self._actor_meta_cache[actor_id] = meta
        self._gcs.call("KVPut", {
            "key": f"actor_meta:{actor_id.hex()}",
            "value": serialization.dumps_code(meta)}, retries=3)
        return ActorHandle(actor_id, actor_class._class_name,
                           meta["method_names"],
                           max_concurrency=options.max_concurrency,
                           method_num_returns=meta["method_num_returns"],
                           max_task_retries=options.max_task_retries,
                           method_concurrency_groups=meta[
                               "method_concurrency_groups"])

    def get_actor(self, name: str, namespace: str | None):
        from ant_ray_tpu_torch.actor import ActorHandle  # noqa: PLC0415

        info = self._gcs.call("GetNamedActor", {
            "name": name, "namespace": namespace or self.namespace},
            retries=3)
        if info is None:
            raise ValueError(f"Failed to look up actor {name!r}")
        actor_id = info["actor_id"]
        meta = self._actor_meta_cache.get(actor_id)
        if meta is None:
            blob = self._gcs.call(
                "KVGet", {"key": f"actor_meta:{actor_id.hex()}"}, retries=3)
            meta = serialization.loads_code(blob) if blob else {
                "method_names": (), "method_num_returns": {}}
            self._actor_meta_cache[actor_id] = meta
        return ActorHandle(actor_id, info["class_name"],
                           meta["method_names"],
                           method_num_returns=meta["method_num_returns"],
                           max_task_retries=meta.get("max_task_retries", 0),
                           method_concurrency_groups=meta.get(
                               "method_concurrency_groups", {}))

    def kill_actor(self, handle, no_restart: bool = True):
        self._gcs.call("KillActor", {
            "actor_id": handle.actor_id, "no_restart": no_restart}, retries=3)
        state = self._actor_states.get(handle.actor_id)
        if state is not None:
            state.address = ""
        if no_restart:
            self._release_actor_ctor_pins(handle.actor_id)

    def _release_actor_ctor_pins(self, actor_id):
        """Drop constructor-arg pins once the actor can never restart."""
        with self._ref_lock:
            pins = self._actor_ctor_pins.pop(actor_id, None)
            if pins:
                self._unpin_locked(pins)

    def cancel(self, ref, force=False, recursive=True):
        """Best-effort cancellation of a not-yet-executing ACTOR task.

        A call still queued client-side is failed locally with
        :class:`TaskCancelledError`; one already pushed is dropped
        worker-side if its executor has not started it.  Running tasks
        are never interrupted — user code cannot be preempted safely, so
        layers that need in-flight bounds (Serve) shed at dequeue via
        request deadlines and call this for the queued remainder."""
        task_id = ref.id.task_id()
        actor_id = task_id.actor_id()
        nil_fill = b"\xff" * (ActorID.SIZE - JobID.SIZE)
        if actor_id._bytes[JobID.SIZE:] == nil_fill:
            # Normal (non-actor) task: the lease path has no cancel
            # channel yet; keep the round-1 no-op there.
            logger.warning(
                "cancel() supports actor tasks only; ignoring %s", ref)
            return
        self._post_submit(self._cancel_actor_task, actor_id, task_id)

    def _cancel_actor_task(self, actor_id, task_id) -> None:
        """io-loop only: fail the call locally if still queued, else ask
        the worker to drop it before execution (ordered behind the
        already-shipped PushTask on the same connection)."""
        state = self._actor_states.get(actor_id)
        if state is not None:
            for i, (spec, pinned, _attempt) in enumerate(state.queue):
                if spec.task_id == task_id:
                    del state.queue[i]
                    self._store_error(
                        spec, exceptions.TaskCancelledError(
                            task_id, "cancelled before dispatch"))
                    self._unpin(pinned)
                    return
        address = state.address if state is not None else ""
        if address:
            self._send_oneway(address, "CancelTask", {"task_id": task_id})

    def submit_actor_task(self, handle, method_name, args, kwargs,
                          options: TaskOptions):
        actor_id = handle.actor_id
        task_id = TaskID.for_actor_task(actor_id)
        streaming = options.num_returns == "streaming"
        num_returns = -1 if streaming else options.num_returns
        return_refs = []
        if streaming:
            self._register_stream(task_id)
        else:
            for i in range(num_returns):
                oid = ObjectID.for_task_return(task_id, i)
                self.memory.mark_pending(oid)
                return_refs.append(
                    ObjectRef(oid, owner_address=self.address))

        args_payload, pinned = self._pack_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            function_id="",
            function_name=f"{handle.class_name}.{method_name}",
            args_payload=args_payload,
            num_returns=num_returns,
            owner_address=self.address,
            resources={},
            max_retries=(0 if streaming else
                         getattr(handle, "_max_task_retries", 0)),
            actor_id=actor_id,
            method_name=method_name,
            concurrency_group=options.concurrency_group,
        )
        self._trace_attach(spec)

        cfg = global_config()
        if cfg.enable_insight:
            # Unlike the JAX package, which records submits of tasks
            # only: an actor call is an edge of the call graph too, or a
            # cluster that serves from actors shows none.
            from ant_ray_tpu_torch.util import insight  # noqa: PLC0415

            insight.record_call_submit(spec.function_name,
                                       task_id.hex(), self.role)
        if cfg.enable_task_events:
            task_events.record(task_id.hex(), spec.function_name,
                               "submitted", actor_id=actor_id.hex())

        self._post_submit(self._enqueue_actor_task, actor_id, spec, pinned)
        if streaming:
            from ant_ray_tpu_torch.object_ref import ObjectRefGenerator  # noqa: PLC0415

            return ObjectRefGenerator(task_id, self)
        return return_refs[0] if num_returns == 1 else return_refs

    def _enqueue_actor_task(self, actor_id, spec, pinned) -> None:
        """Queue an actor call in submission order (io-loop only)."""
        state = self._actor_states.get(actor_id)
        if state is None:
            state = _ActorSubmitState(actor_id=actor_id)
            self._actor_states[actor_id] = state
        spec.sequence_no = state.next_seq
        state.next_seq += 1
        state.queue.append((spec, pinned, 0))
        if not state.sender_running:
            state.sender_running = True
            _spawn(self._actor_sender(state))

    @staticmethod
    async def _safe_flush(client):
        """Flush deferred frames; connection errors surface through the
        failed futures' done-callbacks (retry path), not here."""
        if client is None:
            return
        try:
            await client.flush_deferred()
        except (RpcConnectionError, OSError):
            pass

    async def _actor_sender(self, state: _ActorSubmitState):
        """Drains the per-actor queue in order; pipelined deferred sends
        coalesce each burst into one transport write, flushed whenever
        the queue empties, the target changes, or the sender suspends
        (ref: SequentialActorSubmitQueue)."""
        client = None
        try:
            while state.queue:
                spec, pinned, attempt = state.queue.popleft()
                if state.dead_reason is not None:
                    self._store_error(spec, exceptions.ActorDiedError(
                        state.actor_id, state.dead_reason))
                    self._unpin(pinned)
                    continue
                if not state.address:
                    # About to suspend on the GCS — ship what we have.
                    await self._safe_flush(client)
                    info = await self._gcs.call_async("WaitActorAlive", {
                        "actor_id": state.actor_id, "timeout": 120.0,
                    }, timeout=-1)
                    if info is None or info["state"] != ACTOR_ALIVE:
                        reason = (info or {}).get("death_reason",
                                                  "actor not found")
                        state.dead_reason = reason or "failed to start"
                        self._release_actor_ctor_pins(state.actor_id)
                        self._store_error(spec, exceptions.ActorDiedError(
                            state.actor_id, state.dead_reason))
                        self._unpin(pinned)
                        continue
                    state.address = info["address"]
                next_client = self._clients.get(state.address)
                if next_client is not client:
                    await self._safe_flush(client)  # old target first
                    client = next_client
                spec.attempt = attempt
                if spec.trace_ctx is not None:
                    spec._t_send = time.perf_counter()
                # Sync defer on a live connection (the hot shape: no
                # coroutine per call); the async path connects/handles
                # chaos when the fast path declines.
                fut = client.try_send_deferred("PushTask", spec)
                if fut is None:
                    try:
                        fut = await client.send_request("PushTask", spec,
                                                        defer=True)
                    except RpcConnectionError:
                        await self._on_actor_connection_loss(
                            state, spec, pinned, attempt)
                        continue
                # Done-callback, not a coroutine per call: at 10k calls/s
                # a task object per reply is measurable loop overhead.
                # Context rides ON the future as a preallocated tuple
                # and the callback is ONE shared bound method — a
                # 4-default lambda per call allocates a closure each.
                fut._art_actor_ctx = (state, spec, pinned, attempt)
                fut.add_done_callback(self._actor_reply_cb)
                if not state.queue:
                    await self._safe_flush(client)
        finally:
            await self._safe_flush(client)
            state.sender_running = False
            if state.queue:  # raced with a new enqueue
                state.sender_running = True
                _spawn(self._actor_sender(state))

    def _on_actor_reply_done(self, fut: asyncio.Future):
        state, spec, pinned, attempt = fut._art_actor_ctx
        self._on_actor_reply(state, spec, pinned, attempt, fut)

    def _on_actor_reply(self, state, spec, pinned, attempt,
                        fut: asyncio.Future):
        try:
            reply = fut.result()
            self._store_returns(spec, reply["returns"])
            self._unpin(pinned)
        except (RpcConnectionError, asyncio.CancelledError):
            _spawn(self._on_actor_connection_loss(
                state, spec, pinned, attempt))
        except Exception as e:  # noqa: BLE001
            self._store_error(spec, exceptions.ArtError(repr(e)))
            self._unpin(pinned)

    async def _on_actor_connection_loss(self, state, spec, pinned, attempt):
        """The actor's worker went away mid-call.  In-flight tasks fail with
        ActorDiedError unless the task allows retries (ref: actor
        max_task_retries semantics — default 0: death during execution is
        surfaced, not replayed against the restarted instance).  New tasks
        re-resolve the address and reach the restarted actor."""
        self._clients.invalidate(state.address)
        state.address = ""
        info = await self._gcs.call_async(
            "GetActorInfo", {"actor_id": state.actor_id}, timeout=10)
        may_restart = info is not None and info["state"] != ACTOR_DEAD
        if may_restart and attempt < spec.max_retries:
            await asyncio.sleep(min(0.05 * 2 ** attempt, 1.0))
            state.queue.appendleft((spec, pinned, attempt + 1))
            if not state.sender_running:
                state.sender_running = True
                _spawn(self._actor_sender(state))
            return
        if not may_restart:
            state.dead_reason = (info or {}).get(
                "death_reason", "worker connection lost") or "worker died"
            self._release_actor_ctor_pins(state.actor_id)
        self._store_error(spec, exceptions.ActorDiedError(
            state.actor_id,
            (info or {}).get("death_reason", "")
            or "the actor died while this call was executing"))
        self._unpin(pinned)

    # ------------------------------------------------------------ info

    def cluster_resources(self):
        return self._gcs.call("ClusterResources", retries=3)

    def available_resources(self):
        return self._gcs.call("AvailableResources", retries=3)

    def nodes(self):
        infos = self._gcs.call("GetAllNodes", retries=3)
        return [{
            "NodeID": info.node_id.hex(),
            "Alive": info.alive,
            "Address": info.address,
            "Resources": info.total_resources,
            "Labels": info.labels,
            "Draining": getattr(info, "draining", False),
            "DrainReason": getattr(info, "drain_reason", ""),
            "DrainDeadline": getattr(info, "drain_deadline", 0.0),
        } for info in infos.values()]
