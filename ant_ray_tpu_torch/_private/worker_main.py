"""Worker process entry point.

Role of the reference's worker main + task execution path (ref:
python/ray/_private/workers/default_worker.py + src/ray/core_worker/
task_execution/task_receiver.h:44): registers with the node daemon, serves
PushTask / InstantiateActor on the in-process core service, and executes
tasks on an executor thread (per-actor ordered; thread pool when the actor
declares max_concurrency > 1; coroutine methods run on a persistent asyncio
loop).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ant_ray_tpu_torch import exceptions
from ant_ray_tpu_torch._private import serialization, task_events
from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.core import ClusterRuntime
from ant_ray_tpu_torch._private.ids import JobID, NodeID, ObjectID, WorkerID
from ant_ray_tpu_torch._private.protocol import IoThread
from ant_ray_tpu_torch._private.specs import (
    ACTOR_ALIVE,
    ACTOR_DEAD,
    ActorSpec,
    PromotedArgs,
    TaskSpec,
)
from ant_ray_tpu_torch._private.worker import CLUSTER_MODE, global_worker
from ant_ray_tpu_torch.object_ref import ObjectRef
from ant_ray_tpu_torch.observability import tracing_plane

logger = logging.getLogger(__name__)

class TaskExecutor:
    """Executes tasks for this worker; one main executor thread (actor order
    preserved), optional thread pool for max_concurrency > 1 actors."""

    # Cancelled-id memory bound: ids for tasks that already ran (or
    # never arrive) must not accumulate forever.
    _CANCEL_CAP = 4096

    def __init__(self, runtime: ClusterRuntime):
        self.runtime = runtime
        # SimpleQueue: C-implemented, ~5x cheaper per put/get than
        # queue.Queue — this hop is on every task execution.
        self.queue: "queue.SimpleQueue[tuple]" = queue.SimpleQueue()
        # Task ids cancelled via art.cancel before execution started
        # (CancelTask RPC); checked at both dequeue points so a task
        # parked in the pool's backlog is dropped, not run.
        self._cancelled: "dict[bytes, bool]" = {}
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._cancel_lock = make_lock("worker.cancelled_ids")
        self.actor_instance = None
        self.actor_spec: ActorSpec | None = None
        self._async_loop: asyncio.AbstractEventLoop | None = None
        # Named bounded executor pools (ref: ConcurrencyGroupManager,
        # src/ray/core_worker/task_execution/concurrency_group_manager.h):
        # "" is the default pool, sized by max_concurrency; each declared
        # concurrency group gets its own pool so one group saturating
        # never starves another.
        self._group_pools: dict[str, "ThreadPoolExecutor"] = {}
        self._io = IoThread.get()
        # Coalesced reply channel: executor threads append completed
        # replies here and schedule ONE io-loop drain for the whole
        # burst (the _post_submit idiom) instead of one
        # call_soon_threadsafe per call — the drain resolves every
        # future in the same loop tick, which is what lets the server's
        # hot-ack batch ship a burst of replies as one frame.
        self._reply_inbox: "deque[tuple]" = deque()
        self._reply_scheduled = False
        self._main = threading.Thread(target=self._run_loop, daemon=True,
                                      name="art-executor")
        self._main.start()

    def submit(self, spec, reply_fut: asyncio.Future):
        self.queue.put((spec, reply_fut))

    def _reply(self, fut: asyncio.Future, value):
        self._post_reply(fut, value, False)

    def _reply_exc(self, fut: asyncio.Future, exc: Exception):
        self._post_reply(fut, exc, True)

    def _post_reply(self, fut: asyncio.Future, value, is_exc: bool):
        # Flag-coalesced wakeup: while the io loop has not yet run a
        # scheduled drain, further completions just append — a burst
        # whose replies land while the loop is busy resolves in ONE
        # tick, which is what lets the server's hot-ack batch ship
        # them as one frame.  The flag is cleared before draining, so
        # an append racing the drain at worst costs a redundant
        # (harmless) wakeup, never a lost reply.  Deliberately NOT
        # gated on the task queue: holding a reply while a later task
        # executes can deadlock callers whose blocked call (e.g. a
        # coordination barrier) is what the deferred reply would have
        # unblocked.
        self._reply_inbox.append((fut, value, is_exc))
        if not self._reply_scheduled:
            self._reply_scheduled = True
            self._io.loop.call_soon_threadsafe(self._drain_replies)

    def _drain_replies(self):
        self._reply_scheduled = False
        inbox = self._reply_inbox
        while inbox:
            fut, value, is_exc = inbox.popleft()
            if fut.done():
                continue
            if is_exc:
                fut.set_exception(value)
            else:
                fut.set_result(value)

    def _run_loop(self):
        while True:
            spec, fut = self.queue.get()
            if spec is None:
                return
            aspec = self.actor_spec
            group = getattr(spec, "concurrency_group", "") or ""
            # Declaring ANY concurrency group makes the actor threaded
            # (ref semantics: grouped actors give up per-call ordering),
            # so a long default-group call can never starve the groups.
            threaded = aspec is not None and (
                aspec.max_concurrency > 1 or aspec.concurrency_groups)
            if group and not threaded:
                # Same loud failure _pool_for gives grouped actors: a
                # group name on an ungrouped actor is a caller bug, not
                # something to silently run inline.
                self._reply_exc(fut, exceptions.ArtError(
                    f"concurrency group {group!r} requested but this "
                    "actor declares no concurrency_groups"))
            elif threaded:
                try:
                    self._pool_for(group).submit(
                        self._execute_safely, spec, fut)
                except Exception as e:  # noqa: BLE001 — bad group etc.
                    self._reply_exc(fut, exceptions.ArtError(repr(e)))
            else:
                self._execute_safely(spec, fut)

    def _pool_for(self, group: str) -> "ThreadPoolExecutor":
        pool = self._group_pools.get(group)
        if pool is None:
            aspec = self.actor_spec
            if group:
                limit = (aspec.concurrency_groups or {}).get(group)
                if limit is None:
                    # Loud failure, not a silent 1-wide pool: an
                    # undeclared group (e.g. via .options()) is a caller
                    # bug the creation-time check can't see.
                    raise exceptions.ArtError(
                        f"concurrency group {group!r} is not declared on "
                        f"this actor (declared: "
                        f"{sorted(aspec.concurrency_groups or ())})")
            else:
                limit = aspec.max_concurrency
            pool = ThreadPoolExecutor(
                max_workers=max(1, int(limit or 1)),
                thread_name_prefix=f"art-cg-{group or 'default'}")
            self._group_pools[group] = pool
        return pool

    def cancel(self, task_id) -> None:
        """Mark a task cancelled; it is dropped if not yet executing.
        Running tasks are unaffected (cooperative model)."""
        with self._cancel_lock:
            self._cancelled[task_id._bytes] = True
            while len(self._cancelled) > self._CANCEL_CAP:
                self._cancelled.pop(next(iter(self._cancelled)))

    def _take_cancelled(self, spec: TaskSpec) -> bool:
        with self._cancel_lock:
            return self._cancelled.pop(spec.task_id._bytes, False)

    def _execute_safely(self, spec: TaskSpec, fut: asyncio.Future):
        if self._take_cancelled(spec):
            self._reply(fut, self._error_returns(
                spec, exceptions.TaskCancelledError(
                    spec.task_id, "cancelled before execution")))
            return
        # Propagated trace: the spec carries a sampled context minted at
        # the ingress — set it for the duration of execution so nested
        # submits / gets / pulls from user code land in the same trace,
        # and record the server-side execution span (stages: queue =
        # arrival → executor pickup, execute = user code).
        wire = spec.trace_ctx
        trace_token = exec_ctx = None
        t_wall = t0 = 0.0
        if wire is not None:
            exec_ctx = tracing_plane.TraceContext.from_wire(wire).child()
            trace_token = tracing_plane.set_current(exec_ctx)
            t_wall = time.time()
            t0 = time.perf_counter()
        try:
            result = self._execute(spec)
            if exec_ctx is not None:
                try:
                    self._record_exec_span(spec, exec_ctx, wire, t_wall,
                                           t0, result)
                except Exception:  # noqa: BLE001 — never lose the reply
                    logger.exception("exec span recording failed")
            self._reply(fut, result)
        except SystemExit:
            self._reply(fut, self._error_returns(
                spec, exceptions.ActorDiedError(
                    spec.actor_id, "actor exited via exit_actor()")))
            _report_actor_state(self.runtime, self.actor_spec, ACTOR_DEAD,
                                reason="exit_actor()")
            os._exit(0)
        except Exception as e:  # noqa: BLE001 — internal failure
            logger.exception("internal executor failure")
            self._reply_exc(fut, exceptions.ArtError(repr(e)))
        finally:
            if trace_token is not None:
                tracing_plane.reset(trace_token)

    def _record_exec_span(self, spec: TaskSpec, exec_ctx, wire,
                          t_wall: float, t0: float, result: dict) -> None:
        now = time.perf_counter()
        queue_s = max(0.0, t0 - getattr(spec, "_t_arrival", t0))
        exec_s = now - t0
        err = False
        for kind, data in result.get("returns") or ():
            if kind == "error" or (kind == "stream_end"
                                   and data[1] is not None):
                err = True
                break
        tracing_plane.record_span(
            exec_ctx, f"run:{spec.function_name}",
            ts=t_wall - queue_s, dur_s=queue_s + exec_s,
            stages={"queue": queue_s, "execute": exec_s},
            attrs={"task_id": spec.task_id.hex(),
                   "attempt": spec.attempt,
                   **({"actor_id": spec.actor_id.hex()}
                      if spec.actor_id else {})},
            error=err, span_id=exec_ctx.span_id, parent_id=wire[1],
            service="worker")
        tracing_plane.record_rpc(
            "PushTask", {"queue": queue_s, "execute": exec_s},
            exec_ctx.trace_id)

    # ---- execution

    def _execute(self, spec: TaskSpec) -> dict:
        # Adopt the submitting job's identity: nested submits from this
        # task must carry the job's id (virtual-cluster fencing and
        # task-id lineage key off it).  Skipped when unchanged — id
        # construction is measurable at 10k tasks/s.
        if self.runtime.job_id._bytes != spec.task_id._bytes[:4]:
            self.runtime.job_id = spec.task_id.job_id()
        try:
            args, kwargs = self._load_args(spec)
        except exceptions.ArtError as e:
            # A dependency failed: propagate the *original* error through
            # this task's returns (error lineage, ref: RayTaskError chains).
            return self._error_returns(spec, e)
        insight = None
        if global_config().enable_insight:
            from ant_ray_tpu_torch.util import insight  # noqa: PLC0415

            insight.record_call_begin(spec.function_name,
                                      spec.task_id.hex())
            started = time.monotonic()
        events = None
        if global_config().enable_task_events:
            events = task_events
            events.record(
                spec.task_id.hex(), spec.function_name, "started",
                actor_id=spec.actor_id.hex() if spec.actor_id else None,
                attempt=spec.attempt)
            # Nested submissions from this task record it as parent.
            _task_token = events.current_task.set(spec.task_id.hex())
        try:
            if spec.actor_id is not None:
                if self.actor_instance is None:
                    raise exceptions.ActorDiedError(
                        spec.actor_id, "actor instance not initialized")
                if spec.method_name == "__art_exec_loop__":
                    # Compiled-DAG execution loop: occupies this actor
                    # until the driver tears the channels down
                    # (ref: compiled_dag_node.py actor exec loops).
                    from ant_ray_tpu_torch.dag.compiled import exec_loop  # noqa: PLC0415

                    result = exec_loop(self.actor_instance, *args,
                                       **kwargs)
                elif spec.method_name == "__art_collective__":
                    # Collective DAG node: the op runs against the
                    # group this actor created with
                    # init_collective_group (ref: collective_node.py).
                    from ant_ray_tpu_torch.dag.collective import execute_op  # noqa: PLC0415

                    result = execute_op(*args, **kwargs)
                else:
                    method = getattr(self.actor_instance,
                                     spec.method_name)
                    result = method(*args, **kwargs)
            else:
                fn = self.runtime.fetch_code(spec.function_id)
                result = fn(*args, **kwargs)
            # inspect, not asyncio: on Python < 3.12 asyncio.iscoroutine
            # also matches PLAIN GENERATORS (legacy generator-based
            # coroutine support), which would feed a streaming task's
            # generator to the event loop ("Task got bad yield").
            if inspect.iscoroutine(result):
                result = self._run_coroutine(result)
        except SystemExit:
            raise
        except Exception as e:  # noqa: BLE001 — app error → error returns
            err_cls = (exceptions.ActorError if spec.actor_id is not None
                       else exceptions.TaskError)
            err = err_cls.from_exception(spec.function_name, e)
            if insight is not None:
                insight.record_call_end(
                    spec.function_name, spec.task_id.hex(),
                    time.monotonic() - started, error=True)
            if events is not None:
                events.current_task.reset(_task_token)
                events.record(spec.task_id.hex(), spec.function_name,
                              "failed", attempt=spec.attempt,
                              error=repr(e))
            return self._error_returns(spec, err)
        if spec.num_returns == -1:  # streaming generator task
            # The stream is consumed HERE — events record after it
            # drains (and with the contextvar still set, so tasks the
            # generator body spawns keep their parent linkage).
            out = self._stream_returns(spec, result)
            _count, stream_err = out["returns"][0][1]
            if insight is not None:
                insight.record_call_end(
                    spec.function_name, spec.task_id.hex(),
                    time.monotonic() - started,
                    error=stream_err is not None)
            if events is not None:
                events.current_task.reset(_task_token)
                events.record(spec.task_id.hex(), spec.function_name,
                              "failed" if stream_err is not None
                              else "finished", attempt=spec.attempt,
                              error=(repr(stream_err)
                                     if stream_err is not None
                                     else None))
            return out
        if insight is not None:
            insight.record_call_end(spec.function_name,
                                    spec.task_id.hex(),
                                    time.monotonic() - started)
        if events is not None:
            events.current_task.reset(_task_token)
            events.record(spec.task_id.hex(), spec.function_name,
                          "finished", attempt=spec.attempt)
        values = [result] if spec.num_returns == 1 else list(result)
        if len(values) != spec.num_returns:
            err = exceptions.TaskError(
                spec.function_name, None,
                f"expected {spec.num_returns} return values, "
                f"got {len(values)}")
            return self._error_returns(spec, err)
        return {"returns": [self._package(spec, i, v)
                            for i, v in enumerate(values)]}

    def _run_coroutine(self, coro):
        """Async actor methods run on a persistent loop (so the actor can
        hold loop-bound state across calls)."""
        if self._async_loop is None:
            self._async_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._async_loop.run_forever,
                                 daemon=True, name="art-actor-async")
            t.start()
        return asyncio.run_coroutine_threadsafe(
            coro, self._async_loop).result()

    def _load_args(self, spec: TaskSpec):
        ser = serialization.SerializedObject.from_payload(spec.args_payload)
        obj = serialization.deserialize(ser)
        if isinstance(obj, PromotedArgs):
            # Large args were promoted to plasma by the submitter; the
            # fetch registers this worker as a borrower of nested refs.
            args, kwargs = self.runtime.get([obj.ref], timeout=None)[0]
        else:
            args, kwargs = obj
        args = [self._maybe_fetch(a) for a in args]
        kwargs = {k: self._maybe_fetch(v) for k, v in kwargs.items()}
        return args, kwargs

    def _maybe_fetch(self, value):
        if isinstance(value, ObjectRef):
            return self.runtime.get([value], timeout=None)[0]
        return value

    def _stream_returns(self, spec: TaskSpec, result) -> dict:
        """Drive a streaming task: each yielded item is shipped to the
        owner the moment it exists (ordered oneways on one connection),
        so the consumer reads item 0 while the task still runs (ref:
        streaming generator path, task_manager.h:67).  The final reply
        carries the end-of-stream marker (count + optional error)."""
        count = 0
        error_payload = None
        owner = self.runtime._clients.get(spec.owner_address)
        try:
            for item in result:
                kind, data = self._package(spec, count, item)
                fut = asyncio.run_coroutine_threadsafe(
                    owner.oneway_async("StreamItem", {
                        "task_id": spec.task_id,
                        "index": count,
                        "kind": kind,
                        "data": data,
                    }), self._io.loop)
                fut.result(timeout=60)
                count += 1
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            err_cls = (exceptions.ActorError if spec.actor_id is not None
                       else exceptions.TaskError)
            err = err_cls.from_exception(spec.function_name, e)
            error_payload = serialization.serialize_error(err).to_payload()
        return {"returns": [("stream_end", (count, error_payload))]}

    def _package(self, spec: TaskSpec, index: int, value):
        oid = ObjectID.for_task_return(spec.task_id, index)
        ser = serialization.serialize(value)
        nbytes = ser.payload_nbytes()
        if nbytes <= global_config().max_inline_object_size:
            return ("inline", ser.to_payload())
        self.runtime._write_plasma(oid, ser)  # serializes into the arena
        return ("plasma", nbytes)

    def _error_returns(self, spec: TaskSpec, err: Exception) -> dict:
        payload = serialization.serialize_error(err).to_payload()
        if spec.num_returns == -1:
            # Streaming task failed before (or instead of) producing a
            # generator: the owner expects exactly one end-of-stream
            # marker, never `[...] * -1 == []`.
            return {"returns": [("stream_end", (0, payload))]}
        return {"returns": [("error", payload)] * spec.num_returns}

def _report_actor_state(runtime: ClusterRuntime, spec: ActorSpec | None,
                        state: str, address: str = "", reason: str = ""):
    if spec is None:
        return
    try:
        runtime._gcs.call("ActorStateUpdate", {
            "actor_id": spec.actor_id,
            "state": state,
            "address": address,
            "node_id": NodeID.from_hex(os.environ["ART_NODE_ID"]),
            "reason": reason,
        }, timeout=10, retries=3)
    except Exception:  # noqa: BLE001
        logger.exception("failed to report actor state")


def main():  # pragma: no cover — exercised via subprocess in tests
    logging.basicConfig(
        level=global_config().log_level,
        format="[worker %(levelname)s %(asctime)s] %(message)s")
    # `kill -USR1 <worker pid>` dumps all thread stacks to the worker's
    # stderr log (the reference's `ray stack` equivalent for debugging
    # a wedged worker).
    import faulthandler  # noqa: PLC0415
    import signal  # noqa: PLC0415

    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError):  # non-posix / no signal here
        pass

    # The JAX package pins its workers' jax platform here
    # (ART_JAX_PLATFORM); a worker of the port imports torch only when a
    # task needs it and picks the card there, so there is nothing to pin.

    node_address = os.environ["ART_NODE_ADDRESS"]
    gcs_address = os.environ["ART_GCS_ADDRESS"]
    store_dir = os.environ["ART_STORE_DIR"]
    worker_id = WorkerID.from_hex(os.environ["ART_WORKER_ID"])

    runtime = ClusterRuntime(
        role="worker",
        job_id=JobID.from_random(),  # replaced per-task by spec job ids
        gcs_address=gcs_address,
        node_address=node_address,
        store_dir=store_dir,
        worker_id=worker_id,
    )
    global_worker.runtime = runtime
    global_worker.mode = CLUSTER_MODE

    # Continuous CPU profiling: workers use the module singleton with
    # the default runtime-oneway publisher (global_worker is bound now).
    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

    cpu_profiler.start("worker")

    executor = TaskExecutor(runtime)
    io = IoThread.get()

    def handle_push_task(spec: TaskSpec):
        # Sync fast-route handler: returns the reply future directly, so
        # the server writes the reply from a callback with no Task
        # object per call (see RpcServer.fast_route).
        if spec.trace_ctx is not None:
            spec._t_arrival = time.perf_counter()  # queue-stage anchor
        fut = io.loop.create_future()
        executor.submit(spec, fut)  # sync enqueue preserves arrival order
        return fut

    async def handle_instantiate(spec: ActorSpec):
        executor.actor_spec = spec
        if spec.job_id is not None:
            runtime.job_id = spec.job_id  # actor belongs to its job
        fut = asyncio.get_running_loop().create_future()

        def _do_instantiate():
            try:
                cls = runtime.fetch_code(spec.class_id)
                ser = serialization.SerializedObject.from_payload(
                    spec.args_payload)
                obj = serialization.deserialize(ser)
                if isinstance(obj, PromotedArgs):
                    args, kwargs = runtime.get([obj.ref], timeout=None)[0]
                else:
                    args, kwargs = obj
                args = [executor._maybe_fetch(a) for a in args]
                kwargs = {k: executor._maybe_fetch(v)
                          for k, v in kwargs.items()}
                executor.actor_instance = cls(*args, **kwargs)
                _report_actor_state(runtime, spec, ACTOR_ALIVE,
                                    address=runtime.address)
                io.loop.call_soon_threadsafe(fut.set_result, True)
            except Exception as e:  # noqa: BLE001
                tb = traceback.format_exc()
                logger.error("actor init failed: %s", tb)
                _report_actor_state(
                    runtime, spec, ACTOR_DEAD,
                    reason=f"creation task failed: {e!r}")
                io.loop.call_soon_threadsafe(fut.set_result, False)
                threading.Timer(0.2, lambda: os._exit(1)).start()

        threading.Thread(target=_do_instantiate, daemon=True).start()
        return await fut

    async def handle_ping(_payload):
        return "pong"

    async def handle_cancel(payload):
        executor.cancel(payload["task_id"])
        return True

    runtime.server.routes({
        "InstantiateActor": handle_instantiate,
        "Ping": handle_ping,
        "CancelTask": handle_cancel,
    })
    runtime.server.fast_route("PushTask", handle_push_task)

    runtime._node.call("RegisterWorker", {
        "worker_id": worker_id,
        "address": runtime.address,
        "pid": os.getpid(),
    }, retries=5)
    logger.info("worker %s serving at %s", worker_id.hex()[:8],
                runtime.address)

    # Die with the node daemon (a real node failure takes its workers;
    # the simulated one via Cluster.remove_node must behave the same).
    failures = 0
    while True:
        try:
            runtime._node.call("GetNodeInfo", timeout=5)
            failures = 0
        except Exception:  # noqa: BLE001
            failures += 1
            if failures >= 3:
                logger.warning("node daemon unreachable; worker exiting")
                os._exit(1)
        threading.Event().wait(2.0)


if __name__ == "__main__":
    main()
