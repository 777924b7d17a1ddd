"""Public API: init / shutdown / remote / get / put / wait / actors.

Parity surface with the reference's top-level API
(ref: python/ray/_private/worker.py:1431 ray.init, :2885 ray.get, :3032
ray.put, :3487 ray.remote).

``init(local_mode=True)`` executes tasks and actor calls in this
process, on the caller's devices, so a task may take and return CUDA
tensors as they are.  Otherwise ``init`` starts (or joins) a cluster: a
GCS, node daemons and worker processes, where a CUDA tensor crosses a
process boundary as its bytes and lands on the receiver's card.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Sequence

from ant_ray_tpu_torch._private import worker as worker_mod
from ant_ray_tpu_torch._private.config import Config, set_global_config
from ant_ray_tpu_torch._private.ids import JobID
from ant_ray_tpu_torch._private.task_options import ActorOptions, TaskOptions
from ant_ray_tpu_torch._private.worker import (CLUSTER_MODE, LOCAL_MODE,
                                               global_worker)
from ant_ray_tpu_torch.actor import ActorClass, ActorHandle
from ant_ray_tpu_torch.object_ref import ObjectRef
from ant_ray_tpu_torch.remote_function import RemoteFunction


def init(
    address: str | None = None,
    *,
    local_mode: bool = False,
    num_cpus: int | None = None,
    num_gpus: int | None = None,
    num_tpus: int | None = None,
    resources: dict | None = None,
    object_store_memory: int | None = None,
    namespace: str | None = None,
    _system_config: dict | None = None,
    ignore_reinit_error: bool = False,
) -> "ClientContext":
    """Start (or connect to) a cluster and bind this process as a driver.

    - ``address=None``: start a fresh single-node cluster in subprocesses
      (GCS + node daemon + workers), like ``ray.init()``.  The node
      advertises ``"GPU"``: the NVIDIA cards it detects, or ``num_gpus``
      where given (``num_tpus`` names a ``"TPU"`` resource as in the JAX
      package, so callers of both packages pass the same arguments).
    - ``address="host:port"``: connect to an existing GCS as a driver
      (the process must be on a cluster node).
    - ``address="art://host:port"``: connect from outside the cluster
      through a client server (``python -m
      ant_ray_tpu_torch.util.client.server``); this process runs no
      daemons, and every call is one RPC to that server.
    - ``local_mode=True``: synchronous in-process execution, no daemons.
      The arguments that size or name a cluster (``num_cpus``,
      ``num_gpus``, ``num_tpus``, ``resources``,
      ``object_store_memory``, ``namespace``) have nothing to act on
      there and raise ``ValueError``.
    """
    if global_worker.connected:
        if ignore_reinit_error:
            return ClientContext(global_worker.mode or "")
        raise RuntimeError("ant_ray_tpu_torch.init() called twice; "
                           "pass ignore_reinit_error=True to allow")
    if local_mode:
        cluster_only = {"num_cpus": num_cpus, "num_gpus": num_gpus,
                        "num_tpus": num_tpus, "resources": resources,
                        "object_store_memory": object_store_memory,
                        "namespace": namespace}
        given = sorted(k for k, v in cluster_only.items() if v is not None)
        if given:
            raise ValueError(
                f"init(local_mode=True, {', '.join(given)}=...): these "
                "size or name a cluster, and local mode starts none")

    config = Config().apply_env_overrides().apply_dict(_system_config)
    if object_store_memory:
        config.object_store_memory = object_store_memory
    set_global_config(config)
    # Import-time factory calls (the worker singleton's) cached a
    # pre-init lockcheck verdict; re-evaluate now that _system_config
    # is applied (spawned processes get theirs via the env export below).
    from ant_ray_tpu_torch._lint import lockcheck  # noqa: PLC0415

    lockcheck.refresh_enabled()
    job_id = JobID.from_random()
    global_worker.job_id = job_id

    if local_mode:
        global_worker.runtime = worker_mod.LocalModeRuntime(job_id)
        global_worker.mode = LOCAL_MODE
        return ClientContext(LOCAL_MODE)

    if address is not None and address.startswith("art://"):
        from ant_ray_tpu_torch.util.client import ClientRuntime  # noqa: PLC0415

        global_worker.runtime = ClientRuntime.connect(
            address.removeprefix("art://"))
        global_worker.mode = CLUSTER_MODE
        _register_atexit_once()
        return ClientContext(CLUSTER_MODE)

    # Propagate _system_config to the daemons/workers this driver will
    # spawn: flags travel as ART_<NAME> env vars, the same channel the
    # reference uses to embed _system_config into raylet launch
    # (ref: services.py:1518).  Undone by shutdown().
    if _system_config:
        import json  # noqa: PLC0415

        for key, value in _system_config.items():
            name = f"ART_{key.upper()}"
            _exported_config_env.append((name, os.environ.get(name)))
            os.environ[name] = (
                json.dumps(value) if isinstance(value, (dict, list))
                else str(value))
    if object_store_memory:
        name = "ART_OBJECT_STORE_MEMORY"
        _exported_config_env.append((name, os.environ.get(name)))
        os.environ[name] = str(object_store_memory)

    from ant_ray_tpu_torch._private.core import ClusterRuntime  # noqa: PLC0415

    try:
        global_worker.runtime = ClusterRuntime.create(
            address=address,
            job_id=job_id,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            num_tpus=num_tpus,
            resources=resources,
            namespace=namespace or "default",
            config=config,
        )
    except BaseException:
        _restore_config_env()
        raise
    global_worker.mode = CLUSTER_MODE
    # Continuous CPU profiling of the driver itself (submission-path
    # attribution: serialize vs frame-encode vs task_events vs io-loop
    # — the item the `profile --diff` A/B tool exists for).
    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

    cpu_profiler.start("driver")
    _register_atexit_once()
    return ClientContext(
        CLUSTER_MODE,
        dashboard_url=getattr(global_worker.runtime, "dashboard_url", ""))


_atexit_registered = False


def _register_atexit_once():
    global _atexit_registered
    if not _atexit_registered:
        import atexit  # noqa: PLC0415

        atexit.register(shutdown)  # shutdown() is idempotent
        _atexit_registered = True


_exported_config_env: list = []


def _restore_config_env() -> None:
    """Undo _system_config env exports (restoring any pre-existing user
    value) so the next init() in this process starts clean."""
    while _exported_config_env:
        name, prior = _exported_config_env.pop()
        if prior is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prior


class ClientContext:
    def __init__(self, mode: str, dashboard_url: str = ""):
        self.mode = mode
        self.dashboard_url = dashboard_url

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutdown()

    def disconnect(self):
        shutdown()


def shutdown() -> None:
    from ant_ray_tpu_torch._private import task_events  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

    try:
        task_events.flush()  # drain before the runtime goes away
    except Exception:  # noqa: BLE001 — observability must not block
        pass             # the disconnect (events are best-effort)
    cpu_profiler.stop()  # idempotent; final publish rides the runtime
    global_worker.shutdown()
    _restore_config_env()


def is_initialized() -> bool:
    return global_worker.connected


def remote(*args, **options):
    """``@remote`` decorator for functions and classes
    (ref: worker.py:3487)."""
    if len(args) == 1 and not options and (
            inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote with arguments must be used as "
                        "@remote(num_cpus=..., ...)")

    def decorator(fn_or_cls):
        return _make_remote(fn_or_cls, options)

    return decorator


def _make_remote(fn_or_cls, options: dict):
    if inspect.isclass(fn_or_cls):
        opts = ActorOptions().merged_with(**options)
        return ActorClass(fn_or_cls, opts)
    opts = TaskOptions().merged_with(**options)
    return RemoteFunction(fn_or_cls, opts)


def method(num_returns: int = 1, concurrency_group: str = ""):
    """Per-method options on actor classes (ref: ray.method)."""

    def decorator(fn):
        fn.__art_num_returns__ = num_returns
        if concurrency_group:
            fn.__art_concurrency_group__ = concurrency_group
        return fn

    return decorator


def get(refs, *, timeout: float | None = None):
    return global_worker.get(refs, timeout)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    global_worker._check_connected()
    return global_worker.put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return global_worker.wait(refs, num_returns, timeout, fetch_local)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    global_worker._check_connected()
    return global_worker.runtime.get_actor(name, namespace)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    global_worker._check_connected()
    global_worker.runtime.kill_actor(actor, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = True) -> None:
    global_worker._check_connected()
    global_worker.runtime.cancel(ref, force, recursive)


def cluster_resources() -> dict:
    global_worker._check_connected()
    return global_worker.runtime.cluster_resources()


def available_resources() -> dict:
    global_worker._check_connected()
    return global_worker.runtime.available_resources()


def nodes() -> list[dict]:
    global_worker._check_connected()
    return global_worker.runtime.nodes()


def timeline(filename: str | None = None):
    """Chrome trace of the cluster's task schedule, with the sampled
    request spans and published step records as rows of their own (ref:
    ray.timeline).  With ``filename`` writes the JSON and returns the
    path; without, returns the event list."""
    global_worker._check_connected()
    from ant_ray_tpu_torch.util.timeline import timeline as _timeline  # noqa: PLC0415

    return _timeline(filename)
