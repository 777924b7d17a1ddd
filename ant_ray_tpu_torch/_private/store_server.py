"""Standalone GCS-table store service — the shared-store HA backend.

Role of the reference's Redis-backed GCS persistence (ref:
src/ray/gcs/store_client/redis_store_client.h + the ant fork's
Redis-lease leader election, python/ray/ha/redis_leader_selector.py:90):
the head's tables live OUTSIDE the head machine, so a standby head on
another machine can restore the cluster after the primary dies.
Redesigned for this stack: a small asyncio RPC service (the framework's
own protocol, no Redis dependency) hosting the sqlite store plus a
compare-and-swap lease table for cross-machine leader election.

Run:  python -m ant_ray_tpu_torch._private.store_server --port P --path DB
Point heads at it with ``--store art-store://host:port``.
"""

from __future__ import annotations

import logging
import os
import time

from ant_ray_tpu_torch._private.protocol import RpcServer
from ant_ray_tpu_torch._private.store_client import SqliteStoreClient

logger = logging.getLogger(__name__)


class StoreServer:
    """RPC front of a SqliteStoreClient + TTL leases (leader election)."""

    def __init__(self, path: str, host: str = "127.0.0.1", port: int = 0):
        self._store = SqliteStoreClient(path)
        self._server = RpcServer(host, port)
        # lease name -> {"holder", "token", "expires_at"}
        self._leases: dict[str, dict] = {}
        self.address = ""

    def start(self) -> str:
        self._server.routes({
            "StorePut": self._put,
            "StoreGet": self._get,
            "StoreDelete": self._delete,
            "StoreLoadTable": self._load_table,
            "LeaseAcquire": self._lease_acquire,
            "LeaseRenew": self._lease_renew,
            "LeaseRelease": self._lease_release,
            "LeaseInfo": self._lease_info,
            "Ping": self._ping,
        })
        self.address = self._server.start()
        return self.address

    def stop(self) -> None:
        self._server.stop()
        self._store.close()

    # ------------------------------------------------------------ tables

    async def _put(self, payload):
        self._store.put(payload["table"], payload["key"],
                        payload["value"])
        return True

    async def _get(self, payload):
        return self._store.get(payload["table"], payload["key"])

    async def _delete(self, payload):
        self._store.delete(payload["table"], payload["key"])
        return True

    async def _load_table(self, payload):
        return self._store.load_table(payload["table"])

    async def _ping(self, _payload):
        return "pong"

    # ------------------------------------------------------------ leases
    # Compare-and-swap TTL leases, the Redis SET-NX-PX election pattern
    # (ref: redis_leader_selector.py) — single-threaded on the io loop,
    # so acquire/renew are naturally atomic.

    def _live_lease(self, name: str) -> dict | None:
        lease = self._leases.get(name)
        if lease is None or lease["expires_at"] < time.monotonic():
            return None
        return lease

    async def _lease_acquire(self, payload):
        name = payload["name"]
        lease = self._live_lease(name)
        if lease is not None and lease["token"] != payload["token"]:
            return {"acquired": False, "holder": lease["holder"]}
        self._leases[name] = {
            "holder": payload["holder"],
            "token": payload["token"],
            "expires_at": time.monotonic() + payload["ttl"],
        }
        return {"acquired": True}

    async def _lease_renew(self, payload):
        name = payload["name"]
        lease = self._live_lease(name)
        if lease is None or lease["token"] != payload["token"]:
            return {"renewed": False}   # expired or usurped: fenced out
        lease["expires_at"] = time.monotonic() + payload["ttl"]
        return {"renewed": True}

    async def _lease_release(self, payload):
        lease = self._leases.get(payload["name"])
        if lease is not None and lease["token"] == payload["token"]:
            del self._leases[payload["name"]]
        return True

    async def _lease_info(self, payload):
        lease = self._live_lease(payload["name"])
        if lease is None:
            return None
        return {"holder": lease["holder"], "token": lease["token"]}


def main():  # pragma: no cover — exercised via subprocess in tests
    import argparse
    import signal

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--path", required=True)
    parser.add_argument("--monitor-pid", type=int, default=0)
    args = parser.parse_args()
    logging.basicConfig(level="INFO",
                        format="[store %(levelname)s %(asctime)s] "
                               "%(message)s")
    server = StoreServer(args.path, port=args.port)
    server.start()
    print(f"STORE_READY {server.address}", flush=True)

    stop = False

    def _term(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop:
        time.sleep(0.2)
        if args.monitor_pid and not os.path.exists(
                f"/proc/{args.monitor_pid}"):
            break
    os._exit(0)


if __name__ == "__main__":
    main()
