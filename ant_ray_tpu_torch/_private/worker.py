"""Global worker singleton + runtime interface + local-mode runtime.

The ``Worker`` here plays the role of the reference's per-process worker
singleton (ref: python/ray/_private/worker.py) and delegates to a pluggable
``CoreRuntime`` — the analogue of the C++ CoreWorker
(ref: src/ray/core_worker/core_worker.h:167).  Two runtimes exist:

* ``LocalModeRuntime`` — single-process synchronous execution for unit
  testing without daemons (ref: core_worker.cc:3256 ExecuteTaskLocalMode).
* ``ClusterRuntime`` (``ant_ray_tpu_torch/_private/core.py``) — the
  real multiprocess path: GCS head + node daemons + worker processes.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Sequence

from ant_ray_tpu_torch import exceptions
from ant_ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, _PutIndexCounter
from ant_ray_tpu_torch._private.task_options import ActorOptions, TaskOptions
from ant_ray_tpu_torch.object_ref import ObjectRef

LOCAL_MODE = "local"
CLUSTER_MODE = "cluster"


class CoreRuntime:
    """Interface every runtime implements (mirrors CoreWorker's surface)."""

    def submit_task(self, remote_function, args, kwargs,
                    options: TaskOptions) -> ObjectRef | list[ObjectRef]:
        raise NotImplementedError

    def create_actor(self, actor_class, args, kwargs, options: ActorOptions):
        raise NotImplementedError

    def submit_actor_task(self, handle, method_name, args, kwargs,
                          options: TaskOptions):
        raise NotImplementedError

    def put(self, value: Any) -> ObjectRef:
        raise NotImplementedError

    def get(self, refs: Sequence[ObjectRef], timeout: float | None) -> list:
        raise NotImplementedError

    def wait(self, refs, num_returns: int, timeout: float | None,
             fetch_local: bool):
        raise NotImplementedError

    def get_actor(self, name: str, namespace: str | None):
        raise NotImplementedError

    def kill_actor(self, handle, no_restart: bool = True):
        raise NotImplementedError

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True):
        raise NotImplementedError

    def cluster_resources(self) -> dict:
        raise NotImplementedError

    def available_resources(self) -> dict:
        raise NotImplementedError

    def nodes(self) -> list[dict]:
        raise NotImplementedError

    def shutdown(self):
        raise NotImplementedError


def resolve_value(value, ref_resolver):
    """Resolve a possibly-ObjectRef top-level argument (ref semantics: only
    top-level args are fetched; nested refs are passed through)."""
    if isinstance(value, ObjectRef):
        return ref_resolver(value)
    return value


def maybe_raise(value):
    if isinstance(value, exceptions.TaskError):
        raise value
    if isinstance(value, exceptions.ArtError):
        raise value
    return value


class LocalModeRuntime(CoreRuntime):
    """Synchronous single-process execution: tasks run eagerly at submission,
    objects live in a dict; no daemons, no serialization round-trips (but
    results of failed tasks are stored as TaskError to match cluster-mode
    error lineage)."""

    def __init__(self, job_id: JobID):
        self._job_id = job_id
        self._objects: dict[ObjectID, Any] = {}
        self._actors: dict[ActorID, Any] = {}
        self._actor_meta: dict[ActorID, dict] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}
        self._put_counter = _PutIndexCounter()
        self._driver_task_id = TaskID.for_driver_task(job_id)
        from ant_ray_tpu_torch._lint.lockcheck import make_rlock  # noqa: PLC0415

        self._lock = make_rlock("worker.state")

    # ---- helpers

    def _store(self, task_id: TaskID, values: list) -> list[ObjectRef]:
        refs = []
        for i, v in enumerate(values):
            oid = ObjectID.for_task_return(task_id, i)
            self._objects[oid] = v
            refs.append(ObjectRef(oid, owner_address="local"))
        return refs

    def _resolve(self, ref: ObjectRef):
        if ref.id not in self._objects:
            raise exceptions.ObjectLostError(ref.id, "not found in local mode")
        return maybe_raise(self._objects[ref.id])

    def _resolve_args(self, args, kwargs):
        args = [resolve_value(a, self._resolve) for a in args]
        kwargs = {k: resolve_value(v, self._resolve) for k, v in kwargs.items()}
        return args, kwargs

    def _pack(self, result, num_returns: int) -> list:
        if num_returns == 1:
            return [result]
        return list(result)

    # ---- tasks

    def submit_task(self, remote_function, args, kwargs, options: TaskOptions):
        task_id = TaskID.for_normal_task(self._job_id)
        num_returns = options.num_returns
        if num_returns == "streaming":
            # Local mode executes eagerly; the generator surface is kept
            # so user code is portable.
            rargs, rkwargs = self._resolve_args(args, kwargs)
            result = remote_function.function(*rargs, **rkwargs)
            return iter(self._store(task_id, list(result)))
        try:
            rargs, rkwargs = self._resolve_args(args, kwargs)
            result = remote_function.function(*rargs, **rkwargs)
            values = self._pack(result, num_returns)
        except Exception as e:  # noqa: BLE001 — stored as task error
            err = exceptions.TaskError.from_exception(
                remote_function.function_name, e)
            values = [err] * num_returns
        refs = self._store(task_id, values)
        return refs[0] if num_returns == 1 else refs

    # ---- actors

    def create_actor(self, actor_class, args, kwargs, options: ActorOptions):
        from ant_ray_tpu_torch.actor import ActorHandle  # noqa: PLC0415

        namespace = options.namespace or "default"
        if options.name:
            with self._lock:
                existing = self._named_actors.get((namespace, options.name))
                if existing is not None:
                    if options.get_if_exists:
                        meta = self._actor_meta[existing]
                        return ActorHandle(
                            existing, meta["class_name"], meta["method_names"],
                            method_num_returns=meta["method_num_returns"])
                    raise ValueError(
                        f"Actor name {options.name!r} already taken")
        actor_id = ActorID.of(self._job_id)
        rargs, rkwargs = self._resolve_args(args, kwargs)
        instance = actor_class.cls(*rargs, **rkwargs)
        with self._lock:
            self._actors[actor_id] = instance
            self._actor_meta[actor_id] = {
                "class_name": actor_class._class_name,
                "method_names": actor_class.method_names(),
                "method_num_returns": actor_class.method_num_returns(),
            }
            if options.name:
                self._named_actors[(namespace, options.name)] = actor_id
        return ActorHandle(actor_id, actor_class._class_name,
                           actor_class.method_names(),
                           method_num_returns=actor_class.method_num_returns())

    def submit_actor_task(self, handle, method_name, args, kwargs,
                          options: TaskOptions):
        task_id = TaskID.for_actor_task(handle.actor_id)
        num_returns = options.num_returns
        instance = self._actors.get(handle.actor_id)
        try:
            if instance is None:
                raise exceptions.ActorDiedError(handle.actor_id, "killed")
            rargs, rkwargs = self._resolve_args(args, kwargs)
            method = getattr(instance, method_name)
            result = method(*rargs, **rkwargs)
            # inspect, not asyncio: on Python < 3.12 asyncio.iscoroutine
            # also matches plain generators (streaming actor methods).
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            values = self._pack(result, num_returns)
        except exceptions.ActorDiedError:
            raise
        except Exception as e:  # noqa: BLE001
            err = exceptions.ActorError.from_exception(
                f"{handle.class_name}.{method_name}", e)
            values = [err] * num_returns
        refs = self._store(task_id, values)
        return refs[0] if num_returns == 1 else refs

    def get_actor(self, name: str, namespace: str | None):
        from ant_ray_tpu_torch.actor import ActorHandle  # noqa: PLC0415

        key = (namespace or "default", name)
        actor_id = self._named_actors.get(key)
        if actor_id is None:
            raise ValueError(f"Failed to look up actor {name!r}")
        meta = self._actor_meta[actor_id]
        return ActorHandle(actor_id, meta["class_name"], meta["method_names"],
                           method_num_returns=meta["method_num_returns"])

    def kill_actor(self, handle, no_restart: bool = True):
        with self._lock:
            self._actors.pop(handle.actor_id, None)
            for key, aid in list(self._named_actors.items()):
                if aid == handle.actor_id:
                    del self._named_actors[key]

    def cancel(self, ref, force=False, recursive=True):
        pass  # local mode tasks already completed at submission

    # ---- objects

    def put(self, value: Any) -> ObjectRef:
        idx = self._put_counter.next(self._driver_task_id)
        oid = ObjectID.for_task_return(self._driver_task_id, idx & 0xFFFF_FFFF)
        self._objects[oid] = value
        return ObjectRef(oid, owner_address="local")

    def get(self, refs: Sequence[ObjectRef], timeout: float | None) -> list:
        return [self._resolve(r) for r in refs]

    def wait(self, refs, num_returns, timeout, fetch_local):
        ready = [r for r in refs if r.id in self._objects]
        not_ready = [r for r in refs if r.id not in self._objects]
        return ready[:num_returns], ready[num_returns:] + not_ready

    # ---- cluster info

    def cluster_resources(self):
        import os  # noqa: PLC0415

        return {"CPU": float(os.cpu_count() or 1)}

    def available_resources(self):
        return self.cluster_resources()

    def nodes(self):
        return [{"NodeID": "local", "Alive": True,
                 "Resources": self.cluster_resources()}]

    def shutdown(self):
        self._objects.clear()
        self._actors.clear()
        self._named_actors.clear()


class Worker:
    """Per-process singleton fronting the active runtime."""

    def __init__(self):
        self.mode: str | None = None
        self.runtime: CoreRuntime | None = None
        self.job_id: JobID | None = None
        self.current_actor_id: ActorID | None = None
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._lock = make_lock("worker.connect")

    @property
    def connected(self) -> bool:
        return self.runtime is not None

    def _check_connected(self):
        if self.runtime is None:
            from ant_ray_tpu_torch._private import auto_init  # noqa: PLC0415

            auto_init.auto_init()
        if self.runtime is None:
            raise RuntimeError(
                "ant_ray_tpu_torch.init() must be called before using the "
                "API")

    def submit_task(self, remote_function, args, kwargs, options):
        self._check_connected()
        return self.runtime.submit_task(remote_function, args, kwargs, options)

    def create_actor(self, actor_class, args, kwargs, options):
        self._check_connected()
        return self.runtime.create_actor(actor_class, args, kwargs, options)

    def submit_actor_task(self, handle, method_name, args, kwargs, options):
        self._check_connected()
        return self.runtime.submit_actor_task(
            handle, method_name, args, kwargs, options)

    def put(self, value):
        self._check_connected()
        return self.runtime.put(value)

    def get(self, refs, timeout=None):
        self._check_connected()
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(
                    f"get() expects ObjectRef(s), got {type(r).__name__}")
        values = self.runtime.get(ref_list, timeout)
        return values[0] if single else values

    async def get_async(self, ref: ObjectRef):
        # Round 1: thread-offloaded blocking get (async actors can await refs).
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: self.get(ref))

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        self._check_connected()
        if len(refs) == 0:
            return [], []
        if num_returns <= 0 or num_returns > len(refs):
            raise ValueError(
                f"num_returns must be in [1, {len(refs)}], got {num_returns}")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready, not_ready = self.runtime.wait(
                refs, num_returns, timeout, fetch_local)
            if len(ready) >= num_returns or (
                    deadline is not None and time.monotonic() >= deadline):
                # Contract (matches the reference): at most num_returns
                # refs come back ready; surplus ready refs stay in the
                # continuation list so `done, refs = wait(refs, 1)` loops
                # never drop results.
                if len(ready) > num_returns:
                    not_ready = ready[num_returns:] + not_ready
                    ready = ready[:num_returns]
                return ready, not_ready
            time.sleep(0.005)

    def exit_current_actor(self):
        raise SystemExit(0)

    def shutdown(self):
        with self._lock:
            try:
                if self.runtime is not None:
                    self.runtime.shutdown()
            finally:
                # The disconnect must stick even when a teardown step
                # throws (a dying cluster races its own disconnect):
                # a runtime left behind here turns the NEXT init() in
                # this process into "init() called twice".
                self.runtime = None
                self.mode = None
                self.job_id = None


global_worker = Worker()
