"""Client-side runtime: the ``art://`` proxy connection.

A ``CoreRuntime`` implementation (the same interface local mode and the
in-cluster ``ClusterRuntime`` implement) whose every method is one RPC to
a :class:`~ant_ray_tpu_torch.util.client.server.ClientServer`.  The client
process runs no daemons: ObjectRefs here are mirrors of server-side refs,
released back to the server when garbage collected
(ref: python/ray/util/client/worker.py — the Ray Client data plane).
Values and arguments go to the server as packed payloads that it stores
untouched (``wire.py``), and ``get`` brings stored payloads back to be
deserialized here: a CUDA tensor lands on this process's card.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Sequence

from ant_ray_tpu_torch import exceptions
from ant_ray_tpu_torch._private import serialization
from ant_ray_tpu_torch._private.protocol import RpcClient
from ant_ray_tpu_torch._private.worker import CoreRuntime
from ant_ray_tpu_torch.actor import ActorHandle
from ant_ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator, set_refcount_hook
from ant_ray_tpu_torch.util.client.wire import pack as _pack
from ant_ray_tpu_torch.util.client.wire import unpack as _unpack


class ClientRuntime(CoreRuntime):
    """Proxy runtime behind ``art.init("art://host:port")``."""

    def __init__(self, address: str):
        self._rpc = RpcClient(address)
        self._lock = threading.Lock()
        self._registered: set[str] = set()       # fids/cids known server-side
        self._counts: dict[Any, int] = {}        # oid -> live local mirrors
        self._shutdown = False
        hello = self._rpc.call("ClientHello", {}, retries=3)
        self.protocol_version = hello["version"]
        set_refcount_hook(self._refcount_event)

    @classmethod
    def connect(cls, address: str) -> "ClientRuntime":
        return cls(address)

    # ------------------------------------------------------- ref mirroring

    def _refcount_event(self, event: str, ref: ObjectRef) -> None:
        if self._shutdown:
            return
        oid = ref.id
        with self._lock:
            if event in ("add", "deserialized"):
                self._counts[oid] = self._counts.get(oid, 0) + 1
                return
            if event != "remove":
                return
            n = self._counts.get(oid, 0) - 1
            if n > 0:
                self._counts[oid] = n
                return
            self._counts.pop(oid, None)
        # Fire-and-forget: __del__ may run on ANY thread — including the
        # io-loop thread itself — so a blocking call here could deadlock.
        import asyncio  # noqa: PLC0415

        try:
            asyncio.run_coroutine_threadsafe(
                self._rpc.oneway_async("ClientRelease", {"oids": [oid]}),
                self._rpc._io.loop)
        except Exception:  # noqa: BLE001 — interpreter teardown / lost link
            pass

    def _mirror(self, wire) -> ObjectRef:
        """Build the local mirror of a server-pinned ref.

        The server already counted one pin for this wire handle, and the
        ObjectRef constructor fires the "add" hook — so pins and mirrors
        stay 1:1 without extra bookkeeping."""
        oid, owner = wire
        return ObjectRef(oid, owner_address=owner)

    def _wire(self, ref: ObjectRef) -> tuple:
        return (ref.id, ref.owner_address)

    def _mirror_result(self, result):
        kind, body = result
        if kind == "ref":
            return self._mirror(body)
        if kind == "refs":
            return [self._mirror(w) for w in body]
        if kind == "stream":
            return ObjectRefGenerator(body, self)
        raise exceptions.ArtError(f"bad submit reply kind {kind!r}")

    # ------------------------------------------------------------ code ship

    def _ensure_function(self, remote_function) -> str:
        fid = getattr(remote_function, "_client_fid", None)
        if fid is None:
            fid = uuid.uuid4().hex
            remote_function._client_fid = fid
        if fid not in self._registered:
            self._rpc.call("ClientRegisterFunction", {
                "fid": fid,
                "code": serialization.dumps_code(remote_function.function),
            })
            self._registered.add(fid)
        return fid

    def _ensure_class(self, actor_class) -> str:
        cid = getattr(actor_class, "_client_cid", None)
        if cid is None:
            cid = uuid.uuid4().hex
            actor_class._client_cid = cid
        if cid not in self._registered:
            self._rpc.call("ClientRegisterClass", {
                "cid": cid,
                "code": serialization.dumps_code(actor_class.cls),
            })
            self._registered.add(cid)
        return cid

    # ------------------------------------------------------------ tasks

    def submit_task(self, remote_function, args, kwargs, options):
        fid = self._ensure_function(remote_function)
        return self._mirror_result(self._rpc.call("ClientSubmitTask", {
            "fid": fid,
            "args": _pack((list(args), dict(kwargs))),
            "options": options,
        }, timeout=0))

    def create_actor(self, actor_class, args, kwargs, options):
        cid = self._ensure_class(actor_class)
        reduced = self._rpc.call("ClientCreateActor", {
            "cid": cid,
            "args": _pack((list(args), dict(kwargs))),
            "options": options,
        }, timeout=0)
        return ActorHandle(*reduced)

    def submit_actor_task(self, handle, method_name, args, kwargs, options):
        return self._mirror_result(self._rpc.call("ClientSubmitActorTask", {
            "handle": handle.__reduce__()[1],
            "method": method_name,
            "args": _pack((list(args), dict(kwargs))),
            "options": options,
        }, timeout=0))

    # ------------------------------------------------------------ objects

    def put(self, value: Any) -> ObjectRef:
        return self._mirror(self._rpc.call(
            "ClientPut", {"value": _pack(value)}, timeout=0))

    def get(self, refs: Sequence[ObjectRef], timeout: float | None) -> list:
        stored = self._rpc.call("ClientGet", {
            "refs": [self._wire(r) for r in refs],
            "timeout": timeout,
        }, timeout=0 if timeout is None else timeout + 30)
        out = []
        for kind, payload in stored:
            value = _unpack(payload)
            if kind == "error":
                raise value
            out.append(value)
        return out

    def wait(self, refs, num_returns, timeout, fetch_local):
        by_oid = {r.id: r for r in refs}
        ready_ids, not_ready_ids = self._rpc.call("ClientWait", {
            "refs": [self._wire(r) for r in refs],
            "num_returns": num_returns,
            "timeout": timeout,
            "fetch_local": fetch_local,
        }, timeout=0)
        return ([by_oid[i] for i in ready_ids],
                [by_oid[i] for i in not_ready_ids])

    # ------------------------------------------------------------ streaming

    def stream_next(self, task_id, index, timeout):
        wire = self._rpc.call("ClientStreamNext", {
            "task_id": task_id, "index": index, "timeout": timeout,
        }, timeout=0)
        return None if wire is None else self._mirror(wire)

    def release_stream(self, task_id, index):
        # Called from ObjectRefGenerator.__del__ — may run on any thread
        # (including the io loop) and at interpreter teardown, so it must
        # never block.
        import asyncio  # noqa: PLC0415

        try:
            asyncio.run_coroutine_threadsafe(
                self._rpc.oneway_async("ClientStreamRelease",
                                       {"task_id": task_id}),
                self._rpc._io.loop)
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------ actors

    def get_actor(self, name: str, namespace: str | None):
        reduced = self._rpc.call("ClientGetActor", {
            "name": name, "namespace": namespace})
        return ActorHandle(*reduced)

    def kill_actor(self, handle, no_restart: bool = True):
        self._rpc.call("ClientKillActor", {
            "handle": handle.__reduce__()[1], "no_restart": no_restart})

    def cancel(self, ref, force=False, recursive=True):
        self._rpc.call("ClientCancel", {
            "ref": self._wire(ref), "force": force, "recursive": recursive})

    # ------------------------------------------------------------ cluster

    def cluster_resources(self) -> dict:
        return self._rpc.call("ClientClusterResources", {})

    def available_resources(self) -> dict:
        return self._rpc.call("ClientAvailableResources", {})

    def nodes(self) -> list[dict]:
        return self._rpc.call("ClientNodes", {})

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        set_refcount_hook(None)
        with self._lock:
            oids = list(self._counts)
            self._counts.clear()
        if oids:
            try:
                self._rpc.call("ClientRelease", {"oids": oids}, timeout=5)
            except Exception:  # noqa: BLE001 — link may already be gone
                pass
        self._rpc.close()
