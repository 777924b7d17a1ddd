"""Client proxy server: hosts remote drivers against one in-cluster runtime.

Role-equivalent to the reference's Ray Client server
(ref: python/ray/util/client/server/server.py — a gRPC proxy that owns a
real driver connection and executes API calls on behalf of remote
clients).  Differences driven by this framework's design:

* transport is the shared asyncio RPC substrate (``_private/protocol.py``)
  rather than a dedicated gRPC service — the same frames, retry and chaos
  machinery as every other control-plane hop;
* object values cross the wire as the object plane's own serialized
  payloads (pickle-5 + out-of-band buffers), and — unlike the JAX
  package's server, which rebuilds each value before it re-serializes
  it — the server stores and forwards them untouched (``wire.py``): a
  CUDA tensor a client puts, passes or gets is never built here, so
  the proxy takes no card and makes no trip through one;
* the server pins every ObjectRef it hands out (``_refs``) and drops the
  pin when the client's mirror of the ref is garbage collected — the
  client side of the ownership protocol collapses to reference mirroring
  (ref: the client-side reference counting in
  python/ray/util/client/common.py).
"""

from __future__ import annotations

import argparse
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from ant_ray_tpu_torch._private import serialization
from ant_ray_tpu_torch._private.ids import JobID
from ant_ray_tpu_torch._private.protocol import RpcServer
from ant_ray_tpu_torch.actor import ActorClass, ActorHandle
from ant_ray_tpu_torch.object_ref import ObjectRef
from ant_ray_tpu_torch.remote_function import RemoteFunction
from ant_ray_tpu_torch.util.client.wire import serialized as _serialized

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = 1


class ClientServer:
    """One proxy server fronting one in-cluster driver runtime."""

    def __init__(self, runtime, host: str = "0.0.0.0", port: int = 0):
        self._runtime = runtime
        self._server = RpcServer(host=host, port=port)
        # Blocking runtime calls (get/wait/submit) must not run on the io
        # loop; a generous pool keeps many concurrently-blocked clients
        # from starving each other.
        self._pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="art-client-srv")
        self._lock = threading.Lock()
        self._functions: dict[str, RemoteFunction] = {}
        self._classes: dict[str, ActorClass] = {}
        # oid -> (ObjectRef, pin count): keeps results alive until every
        # client-side mirror of the ref is released.
        self._refs: dict[Any, list] = {}
        self._streams: dict[Any, Any] = {}  # task_id -> ObjectRefGenerator
        self._server.routes({
            "ClientHello": self._hello,
            "ClientPut": self._put,
            "ClientGet": self._get,
            "ClientWait": self._wait,
            "ClientRegisterFunction": self._register_function,
            "ClientRegisterClass": self._register_class,
            "ClientSubmitTask": self._submit_task,
            "ClientCreateActor": self._create_actor,
            "ClientSubmitActorTask": self._submit_actor_task,
            "ClientGetActor": self._get_actor,
            "ClientKillActor": self._kill_actor,
            "ClientCancel": self._cancel,
            "ClientStreamNext": self._stream_next,
            "ClientStreamRelease": self._stream_release,
            "ClientRelease": self._release,
            "ClientClusterResources": self._cluster_resources,
            "ClientAvailableResources": self._available_resources,
            "ClientNodes": self._nodes,
        })

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        self.address = self._server.start()
        return self.address

    def stop(self) -> None:
        self._server.stop()
        self._pool.shutdown(wait=False)
        with self._lock:
            self._refs.clear()
            self._streams.clear()

    async def _run_blocking(self, fn, *args):
        import asyncio  # noqa: PLC0415

        return await asyncio.get_running_loop().run_in_executor(
            self._pool, fn, *args)

    # ------------------------------------------------------------ ref pins

    def _pin(self, ref: ObjectRef) -> tuple:
        with self._lock:
            entry = self._refs.get(ref.id)
            if entry is None:
                self._refs[ref.id] = [ref, 1]
            else:
                entry[1] += 1
        return (ref.id, ref.owner_address)

    def _pin_result(self, result):
        """Pin a submit result (ref | list[ref]) and return its wire form."""
        if isinstance(result, ObjectRef):
            return ("ref", self._pin(result))
        return ("refs", [self._pin(r) for r in result])

    # ------------------------------------------------------------ handlers

    async def _hello(self, req):
        return {"version": PROTOCOL_VERSION,
                "job_id": self._runtime.job_id}

    async def _put(self, req):
        ser = _serialized(req["value"], self._resolve_ref)
        ref = await self._run_blocking(self._runtime.put_serialized, ser)
        return self._pin(ref)

    async def _get(self, req):
        refs = [self._resolve_ref(w) for w in req["refs"]]
        stored = await self._run_blocking(
            self._runtime.get_payloads, refs, req["timeout"])
        for kind, payload in stored:
            if kind != "value":
                continue
            # ObjectRefs nested inside a fetched value become client
            # mirrors on deserialize — pin them here so the server-side
            # borrow outlives this handler's transient value, released
            # by the mirror's eventual ClientRelease.
            for r in serialization.refs_in(payload):
                self._pin(r)
        return stored

    async def _wait(self, req):
        import time  # noqa: PLC0415

        refs = [self._resolve_ref(w) for w in req["refs"]]
        num_returns = req["num_returns"]
        timeout = req["timeout"]
        # Satisfy the wait server-side (bounded) so the client's poll loop
        # costs one RPC, not one RPC per 5 ms.
        deadline = time.monotonic() + min(
            30.0, timeout if timeout is not None else 30.0)

        def _poll():
            while True:
                ready, not_ready = self._runtime.wait(
                    refs, num_returns, timeout, req["fetch_local"])
                if len(ready) >= num_returns or time.monotonic() >= deadline:
                    return ready, not_ready
                time.sleep(0.005)

        ready, not_ready = await self._run_blocking(_poll)
        return ([r.id for r in ready], [r.id for r in not_ready])

    def _resolve_ref(self, wire) -> ObjectRef:
        oid, owner = wire
        with self._lock:
            entry = self._refs.get(oid)
            if entry is not None:
                return entry[0]
        # A ref minted elsewhere (e.g. nested inside a value the client
        # unpacked) — reconstruct; the borrow was registered when the
        # server deserialized the containing value.
        return ObjectRef(oid, owner_address=owner, _skip_refcount=True)

    async def _register_function(self, req):
        fn = serialization.loads_code(req["code"])
        with self._lock:
            self._functions[req["fid"]] = RemoteFunction(fn)
        return True

    async def _register_class(self, req):
        cls = serialization.loads_code(req["code"])
        with self._lock:
            self._classes[req["cid"]] = ActorClass(cls)
        return True

    async def _submit_task(self, req):
        with self._lock:
            fn = self._functions.get(req["fid"])
        if fn is None:
            raise KeyError(f"unregistered client function {req['fid']!r}")
        args = _serialized(req["args"], self._resolve_ref)
        options = req["options"]
        result = await self._run_blocking(
            lambda: self._runtime.submit_task(fn, args, None, options))
        if options.num_returns == "streaming":
            with self._lock:
                self._streams[result.task_id] = result
            return ("stream", result.task_id)
        return self._pin_result(result)

    async def _create_actor(self, req):
        with self._lock:
            cls = self._classes.get(req["cid"])
        if cls is None:
            raise KeyError(f"unregistered client actor class {req['cid']!r}")
        args = _serialized(req["args"], self._resolve_ref)
        handle = await self._run_blocking(
            lambda: self._runtime.create_actor(
                cls, args, None, req["options"]))
        return handle.__reduce__()[1]

    async def _submit_actor_task(self, req):
        handle = ActorHandle(*req["handle"])
        args = _serialized(req["args"], self._resolve_ref)
        options = req["options"]
        result = await self._run_blocking(
            lambda: self._runtime.submit_actor_task(
                handle, req["method"], args, None, options))
        if options.num_returns == "streaming":
            with self._lock:
                self._streams[result.task_id] = result
            return ("stream", result.task_id)
        return self._pin_result(result)

    async def _get_actor(self, req):
        handle = await self._run_blocking(
            self._runtime.get_actor, req["name"], req["namespace"])
        return handle.__reduce__()[1]

    async def _kill_actor(self, req):
        handle = ActorHandle(*req["handle"])
        await self._run_blocking(
            lambda: self._runtime.kill_actor(handle, req["no_restart"]))
        return True

    async def _cancel(self, req):
        ref = self._resolve_ref(req["ref"])
        await self._run_blocking(
            lambda: self._runtime.cancel(ref, req["force"], req["recursive"]))
        return True

    async def _stream_next(self, req):
        with self._lock:
            gen = self._streams.get(req["task_id"])
        if gen is None:
            return None

        def _next():
            try:
                return gen.next_with_timeout(req["timeout"])
            except StopIteration:
                return None

        ref = await self._run_blocking(_next)
        if ref is None:
            return None
        return self._pin(ref)

    async def _stream_release(self, req):
        with self._lock:
            self._streams.pop(req["task_id"], None)
        return True

    async def _release(self, req):
        with self._lock:
            for oid in req["oids"]:
                entry = self._refs.get(oid)
                if entry is None:
                    continue
                entry[1] -= 1
                if entry[1] <= 0:
                    del self._refs[oid]
        return True

    async def _cluster_resources(self, req):
        return await self._run_blocking(self._runtime.cluster_resources)

    async def _available_resources(self, req):
        return await self._run_blocking(self._runtime.available_resources)

    async def _nodes(self, req):
        return await self._run_blocking(self._runtime.nodes)


def start_client_server(cluster_address: str, host: str = "0.0.0.0",
                        port: int = 0) -> ClientServer:
    """Connect to ``cluster_address`` as a driver and serve remote clients."""
    from ant_ray_tpu_torch._private.config import Config, set_global_config  # noqa: PLC0415
    from ant_ray_tpu_torch._private.core import ClusterRuntime  # noqa: PLC0415

    config = Config().apply_env_overrides()
    set_global_config(config)
    runtime = ClusterRuntime.create(
        address=cluster_address, job_id=JobID.from_random(),
        num_cpus=None, num_tpus=None, resources=None,
        namespace="default", config=config)
    server = ClientServer(runtime, host=host, port=port)
    server.start()
    return server


def main() -> None:
    parser = argparse.ArgumentParser(description="art client proxy server")
    parser.add_argument("--cluster-address", required=True,
                        help="GCS address of the cluster to front")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args()
    server = start_client_server(args.cluster_address, args.host, args.port)
    print(f"ART_CLIENT_SERVER_READY {server.address}", flush=True)
    threading.Event().wait()  # serve forever


if __name__ == "__main__":
    main()
