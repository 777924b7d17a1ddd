"""Stub node for a scale observatory: the port of the JAX package's
``_private/sim_node.py``, against this package's GCS.

A :class:`StubNode` is a lightweight IN-PROCESS stand-in for a node
daemon that speaks the real wire protocol end-to-end against a real
GCS: it registers with a real ``NodeInfo``, runs the versioned
heartbeat/resource-sync loop (same semantics as
``node_daemon._heartbeat_loop``: view rides the beat only when its
version moved past the acked one, ``unknown_node`` re-registers,
``resync`` resends the full view, phase jitter + failure backoff), it
serves ``LeaseWorker``/``ReturnWorker`` on its own :class:`RpcServer`
so scheduler-granted lease traffic lands on it over TCP, it flushes
task-event batches shaped like ``task_events._expand``'s wire dicts,
and it can park a ``SubPoll`` long-poll subscription.  What it does
NOT have: worker processes, an object-store arena, an agent, spill
queues, or task execution — a lease grant only moves the availability
view (which is exactly what the control plane sees), so ONE driver
process hosts hundreds of stubs on the shared io loop and the GCS
experiences an N-node cluster's full control-plane load.

Fidelity envelope (what a measurement here does/doesn't mean):

* REAL: wire frames + per-connection state at the GCS (each stub owns
  its ClientPool → its own TCP connection and HA router), heartbeat
  ingest cost, versioned view sync, scheduler scan cost per lease,
  pubsub fan-out, task-event fold cost, node-death sweeps, failover
  re-resolve behaviour.
* SIMULATED: lease grants decrement the stub's availability and grant
  a fake worker id — no worker fork, no PushTask, no object traffic.
  A lease that does not fit replies ``infeasible`` instead of queueing
  (the real daemon parks it in a spillback queue).
* ABSENT: data plane, agents, cgroup/memory monitors, log streaming.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.ids import NodeID, TaskID, WorkerID
from ant_ray_tpu_torch._private.protocol import (
    ClientPool,
    IoThread,
    RpcServer,
)
from ant_ray_tpu_torch._private.specs import NodeInfo

logger = logging.getLogger(__name__)


class StubNode:
    """One simulated node: real control-plane protocol, no workers."""

    def __init__(self, gcs_address: str, *, num_cpus: float = 4.0,
                 resources: dict | None = None,
                 labels: dict | None = None):
        self.node_id = NodeID.from_random()
        self._gcs_address = gcs_address
        total = dict(resources or {})
        total.setdefault("CPU", float(num_cpus))
        self._total = total
        self._available = dict(total)
        # Granted worker_id -> resources held (released by ReturnWorker).
        self._leases: dict[WorkerID, dict] = {}
        # Returned worker ids, recycled on the next grant — the real
        # daemon's idle worker pool, minus the processes.  Keeps
        # ReturnWorker idempotent (known-but-idle -> True) and bounds
        # id growth to the concurrent-lease high-water mark.
        self._idle_workers: list[WorkerID] = []
        self._labels = dict(labels or {})
        self._server = RpcServer()
        # Own pool per stub: a real daemon owns its TCP connection (and
        # its leader-aware router under HA) — sharing one pool across
        # stubs would collapse N connections into one and understate
        # per-connection cost at the GCS.
        self._pool = ClientPool()
        self._gcs = None
        self._info: NodeInfo | None = None
        self._stopping = False
        self._tasks: list = []
        self._view_version = 0
        self._sync_wakeup: asyncio.Event | None = None
        self.address = ""
        self.stats = {"beats": 0, "views_sent": 0, "failures": 0,
                      "reregisters": 0, "leases_granted": 0,
                      "leases_infeasible": 0, "leases_returned": 0,
                      "events_flushed": 0, "pub_events_seen": 0,
                      "sub_errors": 0}

    # ------------------------------------------------------- lifecycle

    def start(self, timeout: float = 30.0) -> str:
        """Boot the RPC server, register with the GCS, and start the
        heartbeat loop.  Returns this stub's wire address."""
        self._server.routes({
            "LeaseWorker": self._lease_worker,
            "ReturnWorker": self._return_worker,
            "GetNodeInfo": self._get_node_info,
            "Ping": self._ping,
        })
        self.address = self._server.start()
        self._gcs = self._pool.get(self._gcs_address)
        if hasattr(self._gcs, "_shard_key"):
            # Ring-write sharding (TaskEventsAdd & co) is keyed per
            # producer PROCESS in a real cluster; hundreds of stubs
            # sharing this driver's pid would collapse every ring
            # write onto one replica.  Re-key per stub.
            self._gcs._shard_key = int(self.node_id.hex()[:8], 16)
        self._info = NodeInfo(
            node_id=self.node_id, address=self.address,
            total_resources=dict(self._total),
            available_resources=dict(self._available),
            labels=self._labels)
        io = IoThread.get()
        io.run_coro(self._register(), timeout=timeout)
        self._spawn_loop(self._heartbeat_loop())
        return self.address

    def _spawn_loop(self, coro) -> None:
        task = asyncio.run_coroutine_threadsafe(coro,
                                                IoThread.get().loop)
        self._tasks.append(task)

    def start_task_event_loop(self, rate_hz: float,
                              batch: int = 16) -> None:
        """Open-loop task-event load: ``rate_hz`` events/s flushed in
        TaskEventsAdd batches of ``batch`` (submitted/started/finished
        triples over synthetic task ids)."""
        self._spawn_loop(self._task_event_loop(rate_hz, batch))

    def subscribe(self, channels=("node",)) -> None:
        """Park a long-poll SubPoll subscription on the GCS (each stub
        holds one poller, like a daemon's watch loops)."""
        self._spawn_loop(self._sub_loop(tuple(channels)))

    def stop(self) -> None:
        self._stopping = True
        event = self._sync_wakeup
        if event is not None:
            IoThread.get().call_soon(event.set)
        for task in self._tasks:
            task.cancel()
        self._tasks.clear()
        self._server.stop()
        self._pool.close_all()

    # ------------------------------------------------- GCS-facing side

    async def _register(self) -> None:
        self._info.available_resources = dict(self._available)
        await self._gcs.call_async("RegisterNode", self._info,
                                   timeout=20)

    async def _heartbeat_loop(self) -> None:
        """``node_daemon._heartbeat_loop``'s protocol, compacted: the
        view rides the beat only while unacked, phase-jittered start,
        capped backoff on consecutive failures.  No fail-stop exit —
        stubs share the driver process, and the harness kills the GCS
        on purpose."""
        cfg = global_config()
        period = cfg.heartbeat_period_s
        self._sync_wakeup = asyncio.Event()
        if cfg.heartbeat_jitter and period > 0:
            phase = (int(self.node_id.hex()[:8], 16) % 997) / 997.0
            await asyncio.sleep(phase * period)
        acked = -1
        consecutive_failures = 0
        while not self._stopping:
            payload: dict = {"node_id": self.node_id}
            version = self._view_version
            if version > acked:
                payload["view"] = {
                    "available_resources": dict(self._available),
                    "disk_full": False,
                    "draining": False,
                    "version": version,
                }
            try:
                reply = await self._gcs.call_async("Heartbeat", payload,
                                                   timeout=10)
                if reply.get("unknown_node"):
                    self.stats["reregisters"] += 1
                    await self._register()
                    acked = -1
                else:
                    if "synced" in reply:
                        acked = max(acked, reply["synced"])
                    if "resync" in reply.get("commands", ()):
                        acked = -1
                self.stats["beats"] += 1
                if "view" in payload:
                    self.stats["views_sent"] += 1
                consecutive_failures = 0
            except Exception:  # noqa: BLE001 — head restarting/failing over
                self.stats["failures"] += 1
                consecutive_failures += 1
            wait = period
            if consecutive_failures > 1:
                wait = max(period, min(
                    period * (2 ** (consecutive_failures - 1)),
                    cfg.heartbeat_backoff_cap_s))
            self._sync_wakeup.clear()
            try:
                await asyncio.wait_for(self._sync_wakeup.wait(), wait)
            except asyncio.TimeoutError:
                pass

    async def _task_event_loop(self, rate_hz: float,
                               batch: int) -> None:
        # Flush cadence: a full batch per flush when the rate allows,
        # capped at 1 s so low per-stub rates (an aggregate rate spread
        # over hundreds of stubs) still flush within a short
        # measurement window.
        period = min(batch / max(rate_hz, 0.001), 1.0)
        triples = max(1, int(round(rate_hz * period / 3)))
        node_hex = self.node_id.hex()[:12]
        while not self._stopping:
            await asyncio.sleep(period)
            events = []
            now = time.time()
            for _ in range(triples):
                task_id = TaskID.from_random().hex()
                for event in ("submitted", "started", "finished"):
                    # The wire dict task_events._expand builds — the
                    # GCS folds these through the same state table a
                    # real worker's flush feeds.
                    events.append({
                        "task_id": task_id, "name": "stub_task",
                        "event": event, "ts": now, "pid": 0,
                        "node_id": node_hex, "worker": self.address,
                        "actor_id": None, "parent_task_id": None,
                        "attempt": 0, "job_id": None,
                    })
            try:
                await self._gcs.call_async("TaskEventsAdd",
                                           {"events": events},
                                           timeout=10)
                self.stats["events_flushed"] += len(events)
            except Exception:  # noqa: BLE001 — ride out a failover
                await asyncio.sleep(0.5)

    async def _sub_loop(self, channels: tuple) -> None:
        cursor = -1
        while not self._stopping:
            try:
                reply = await self._gcs.call_async(
                    "SubPoll", {"channels": list(channels),
                                "cursor": cursor, "timeout": 5.0},
                    timeout=30)
                cursor = reply["cursor"]
                self.stats["pub_events_seen"] += len(reply["events"])
            except Exception:  # noqa: BLE001 — ride out a failover
                self.stats["sub_errors"] += 1
                await asyncio.sleep(0.5)

    # ---------------------------------------------- node-facing server

    def _bump_view(self) -> None:
        self._view_version += 1
        if self._sync_wakeup is not None:
            self._sync_wakeup.set()  # sub-period view propagation

    async def _lease_worker(self, payload):
        """Grant shape parity with ``node_daemon._lease_worker_impl``:
        ``{"granted": worker_addr, "worker_id": id}`` (+ ``extra``
        grants from idle capacity for batched leases), or
        ``infeasible`` when the request does not fit — the stub does
        not model the real daemon's spillback queue."""
        resources = payload.get("resources") or {}
        count = max(1, int(payload.get("count", 1)))

        def fits() -> bool:
            return all(self._available.get(k, 0.0) >= v
                       for k, v in resources.items())

        def grant() -> WorkerID:
            worker_id = (self._idle_workers.pop()
                         if self._idle_workers
                         else WorkerID.from_random())
            for key, value in resources.items():
                self._available[key] = self._available.get(key, 0.0) \
                    - value
            self._leases[worker_id] = dict(resources)
            self.stats["leases_granted"] += 1
            return worker_id

        if not fits():
            self.stats["leases_infeasible"] += 1
            return {"infeasible": True,
                    "reason": "stub node saturated"}
        primary = grant()
        extra = []
        while len(extra) < count - 1 and fits():
            extra.append({"granted": self.address,
                          "worker_id": grant()})
        self._bump_view()
        reply = {"granted": self.address, "worker_id": primary}
        if extra:
            reply["extra"] = extra
        return reply

    async def _return_worker(self, payload):
        worker_id = payload.get("worker_id")
        held = self._leases.pop(worker_id, None)
        if held is None:
            # Daemon parity: returning an already-idle worker is a
            # no-op True; only a never-seen worker id is False.
            return worker_id in self._idle_workers
        for key, value in held.items():
            self._available[key] = self._available.get(key, 0.0) + value
        self._idle_workers.append(worker_id)
        self.stats["leases_returned"] += 1
        self._bump_view()
        return True

    async def _get_node_info(self, _payload):
        self._info.available_resources = dict(self._available)
        return self._info

    async def _ping(self, _payload):
        return True


__all__ = ["StubNode"]
