"""Public API: init / shutdown / remote / get / put / wait / actors.

Parity surface with the reference's top-level API
(ref: python/ray/_private/worker.py:1431 ray.init, :2885 ray.get, :3032
ray.put, :3487 ray.remote).

The port runs in local mode only: ``init(local_mode=True)`` executes
tasks and actor calls in this process, on the caller's devices, so a
task may take and return CUDA tensors as they are.  Cluster mode (head,
node daemons, worker processes) is ROADMAP queue A item 6.1b.
"""

from __future__ import annotations

import inspect
from typing import Any, Sequence

from ant_ray_tpu_torch._private import worker as worker_mod
from ant_ray_tpu_torch._private.config import Config, set_global_config
from ant_ray_tpu_torch._private.ids import JobID
from ant_ray_tpu_torch._private.task_options import ActorOptions, TaskOptions
from ant_ray_tpu_torch._private.worker import LOCAL_MODE, global_worker
from ant_ray_tpu_torch.actor import ActorClass, ActorHandle
from ant_ray_tpu_torch.object_ref import ObjectRef
from ant_ray_tpu_torch.remote_function import RemoteFunction


def init(
    address: str | None = None,
    *,
    local_mode: bool = False,
    num_cpus: int | None = None,
    num_tpus: int | None = None,
    resources: dict | None = None,
    object_store_memory: int | None = None,
    namespace: str | None = None,
    _system_config: dict | None = None,
    ignore_reinit_error: bool = False,
) -> "ClientContext":
    """Bind this process as a driver.

    - ``local_mode=True``: synchronous in-process execution, no daemons.
    - Anything else (a fresh cluster, ``address="host:port"``,
      ``address="art://host:port"``) needs cluster mode, which the port
      does not have yet: it raises ``NotImplementedError``.  So do the
      arguments that only size or name a cluster (``num_cpus``,
      ``num_tpus``, ``resources``, ``object_store_memory``,
      ``namespace``): local mode has no use for them.
    """
    if global_worker.connected:
        if ignore_reinit_error:
            return ClientContext(global_worker.mode or "")
        raise RuntimeError("ant_ray_tpu_torch.init() called twice; "
                           "pass ignore_reinit_error=True to allow")
    if not local_mode:
        target = "a fresh cluster" if address is None else repr(address)
        raise NotImplementedError(
            f"init() of {target}: cluster mode (head, node daemons and "
            "worker processes) is not ported yet (ROADMAP queue A item "
            "6.1b); use init(local_mode=True)")
    cluster_only = {"num_cpus": num_cpus, "num_tpus": num_tpus,
                    "resources": resources,
                    "object_store_memory": object_store_memory,
                    "namespace": namespace}
    given = sorted(k for k, v in cluster_only.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"init(local_mode=True, {', '.join(given)}=...): these size or "
            "name a cluster, which the port does not have yet (ROADMAP "
            "queue A item 6.1b)")

    set_global_config(Config().apply_env_overrides().apply_dict(_system_config))
    job_id = JobID.from_random()
    global_worker.job_id = job_id
    global_worker.runtime = worker_mod.LocalModeRuntime(job_id)
    global_worker.mode = LOCAL_MODE
    return ClientContext(LOCAL_MODE)


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
    global_worker.shutdown()


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
