"""Leader-aware GCS client router (the HA half of ClientPool).

``ClientPool.get()`` returns one of these for a comma-joined replica
spec ("host:p1,host:p2,host:p3"), presenting the exact RpcClient call
surface — so every existing ``pool.get(gcs_address)`` call site
(daemons, workers, serve/train controllers, dashboard, CLI) gains HA
routing without changing:

* **mutations** go to the presumed leader; a typed
  :class:`~ant_ray_tpu_torch._private.protocol.NotLeaderError` redirect
  re-targets them, and a dead leader triggers the re-resolve path —
  ``GetHaView`` probes over the known replica set with capped backoff,
  bounded by the ``gcs_failover_timeout_s`` budget — instead of
  surfacing "no route";
* **follower reads** (wire_schema.GCS_FOLLOWER_READS) round-robin over
  live standbys so read load scales with them;
* **ring writes** (wire_schema.GCS_RING_WRITES — task/step/span event
  ingestion) shard by a per-process key over ALL live replicas;
  ``ring_epoch`` increments whenever the live set changes, which is the
  signal producers (task_events.TaskEventBuffer) use to replay their
  terminal-event tails so a killed replica's ring slice cannot lose a
  terminal task state.

With a single known address (no HA deployed) every call degrades to
exactly the plain-RpcClient behavior: same target, same errors, no
failover spinning.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.protocol import (
    IoThread,
    NotLeaderError,
    RpcConnectionError,
    _spawn,
)
from ant_ray_tpu_torch._private.wire_schema import (
    GCS_FOLLOWER_READS,
    GCS_RING_WRITES,
)

logger = logging.getLogger(__name__)

# How long a resolved HA view is trusted before an opportunistic
# background refresh (keeps the follower set and ring shard current
# without a per-call RPC).
_VIEW_TTL_S = 2.0
_MAX_REDIRECTS = 3


def _refused_hold_s() -> float:
    """How long a view may still list a dead replica: the GCS drops a
    replica's ad from its view this long after the ad's last write
    (``gcs_ha.HaCoordinator._stale_cutoff_s``)."""
    cfg = global_config()
    return max(5 * cfg.gcs_ha_sync_period_s, 2 * cfg.gcs_ha_lease_ttl_s)


class GcsRouter:
    """Routes one logical GCS endpoint over a replica set.  Thread-safe
    the same way RpcClient is: all await-side state lives on the io
    loop; the routing tables are whole-object swaps (GIL-atomic reads),
    never in-place mutation."""

    def __init__(self, spec: str, pool):
        self.address = spec              # identity: the original spec
        self._pool = pool
        seeds = [a.strip() for a in spec.split(",") if a.strip()]
        if not seeds:
            raise ValueError(f"empty GCS replica spec: {spec!r}")
        self._known: list[str] = list(dict.fromkeys(seeds))
        # Single-replica fast path: with one known replica there is no
        # leader to resolve, no followers to round-robin, and no ring
        # to shard — bind the plain client once and skip the routing
        # layer entirely (the per-call shard/epoch arithmetic is
        # measurable on the ring-write ingest path).
        self._solo: str | None = (self._known[0]
                                  if len(self._known) == 1 else None)
        self._solo_client = None
        self._leader: str = self._known[0]
        self._followers: list[str] = []
        self._live: list[str] = list(self._known)
        self._rr = 0
        # Ring-shard key: stable per process, so one producer's event
        # stream lands on one replica (the "sharded by key" contract —
        # merged back at query time by the replicas themselves).
        self._shard_key = os.getpid()
        self.ring_epoch = 0
        self._view_ts = 0.0
        # Replicas that refused a connection, with when.  A view keeps
        # listing a dead replica until its last ad ages out on the GCS
        # (``_refused_hold_s``), in the role that ad had: a standby
        # promoted and killed within one sync period still reads as a
        # follower there.  Unlike the JAX package's router, this one
        # takes such a replica back only once it answers a probe or
        # the hold ends, so follower reads and ring writes do not spin
        # on it meanwhile.
        self._refused: dict[str, float] = {}
        self._refreshing = False
        self._io = IoThread.get()
        self._closed = False

    # ------------------------------------------------------------ routing

    def _route(self, method: str) -> str:
        if method in GCS_RING_WRITES:
            live = self._live or [self._leader]
            return live[self._shard_key % len(live)]
        if method in GCS_FOLLOWER_READS:
            followers = self._followers
            if followers:
                self._rr += 1
                return followers[self._rr % len(followers)]
        return self._leader

    def _set_leader(self, addr: str) -> None:
        if addr and addr != self._leader:
            self._leader = addr
            self._followers = [a for a in self._followers if a != addr]

    def _mark_dead(self, addr: str) -> None:
        self._refused[addr] = time.monotonic()
        if addr in self._live and len(self._live) > 1:
            self._live = [a for a in self._live if a != addr]
            self.ring_epoch += 1
        self._followers = [a for a in self._followers if a != addr]

    def _absorb_view(self, view) -> None:
        if not isinstance(view, dict):
            return
        leader = view.get("leader") or ""
        now = time.monotonic()
        hold = _refused_hold_s()
        self._refused = {a: t for a, t in self._refused.items()
                         if now - t < hold}
        replicas = [r for r in view.get("replicas") or []
                    if r.get("address") not in self._refused]
        live = [r["address"] for r in replicas if r.get("address")]
        if not live and view.get("address"):
            live = [view["address"]]
        if set(live) != set(self._live):
            self.ring_epoch += 1
        self._live = live
        self._known = list(dict.fromkeys([*self._known, *live]))
        self._followers = [r["address"] for r in replicas
                           if r.get("address")
                           and r.get("role") != "leader"
                           and r["address"] != leader]
        if leader:
            self._set_leader(leader)
        self._view_ts = time.monotonic()

    async def _resolve(self) -> bool:
        """One probe round over every known replica: adopt the first
        view whose leader answers for itself.  Returns True when a
        live, self-reporting leader is known.  A standby's view can
        lag (it names the leader whose store ad it last synced — which
        may be the replica that just died), so a leader learned second-
        hand is verified by probing it directly."""
        candidates = list(dict.fromkeys(
            [self._leader, *self._live, *self._known]))
        probed: set[str] = set()
        for addr in candidates:
            if addr in probed:
                continue
            probed.add(addr)
            try:
                view = await self._pool.get(addr).call_async(
                    "GetHaView", {}, timeout=2)
            except Exception:  # noqa: BLE001 — dead/slow replica: next
                continue
            self._refused.pop(addr, None)       # it answers again
            self._absorb_view(view)
            if view.get("role") == "leader":
                return True          # straight from the horse's mouth
            leader = view.get("leader")
            if leader and leader not in probed:
                probed.add(leader)
                try:
                    confirm = await self._pool.get(leader).call_async(
                        "GetHaView", {}, timeout=2)
                except Exception:  # noqa: BLE001 — stale second-hand ad
                    continue
                self._refused.pop(leader, None)
                self._absorb_view(confirm)
                if confirm.get("role") == "leader":
                    return True
        return False

    def _maybe_refresh(self) -> None:
        """Opportunistic background view refresh (fire-and-forget):
        keeps follower/ring routing current on a healthy cluster so
        failovers and standby additions are noticed between errors."""
        if len(self._known) <= 1:
            return                      # no HA deployed: nothing to learn
        if self._refreshing or \
                time.monotonic() - self._view_ts < _VIEW_TTL_S:
            return
        self._refreshing = True

        async def _bg():
            try:
                await self._resolve()
            finally:
                self._refreshing = False

        _spawn(_bg())

    # ------------------------------------------------------------- calls

    def _solo_bound(self):
        """The bound plain client of a single-replica spec (re-fetched
        from the pool only if it was invalidated under us)."""
        client = self._solo_client
        if client is None or client._closed:
            client = self._solo_client = self._pool.get(self._solo)
        return client

    async def call_async(self, method: str, payload=None,
                         timeout: float | None = None):
        if self._solo is not None:
            # Plain-RpcClient semantics: same target, same errors, no
            # failover spinning, no routing arithmetic.
            return await self._solo_bound().call_async(
                method, payload, timeout)
        self._maybe_refresh()
        target = self._route(method)
        deadline = None
        delay = 0.05
        redirects = 0
        while True:
            try:
                return await self._pool.get(target).call_async(
                    method, payload, timeout)
            except NotLeaderError as e:
                redirects += 1
                if e.leader_addr and e.leader_addr != target and \
                        redirects <= _MAX_REDIRECTS:
                    # Typed redirect: retarget without burning backoff.
                    self._set_leader(e.leader_addr)
                    target = self._route(method)
                    continue
                # Election in progress (no leader advertised yet, or a
                # redirect loop): fall through to resolve + backoff.
            except RpcConnectionError:
                self._mark_dead(target)
                if len(self._known) <= 1:
                    raise            # single replica: plain semantics
            if deadline is None:
                deadline = time.monotonic() + \
                    global_config().gcs_failover_timeout_s
            if time.monotonic() >= deadline:
                err = RpcConnectionError(
                    f"no reachable GCS leader among {self._known} "
                    "within the failover budget "
                    f"({global_config().gcs_failover_timeout_s:.0f}s)")
                # Tell the sync retry wrapper the budget is already
                # spent: a caller's ``retries=3`` must not multiply a
                # 15s failover budget into a minute-long hang against
                # a fully-dead replica set.
                err.failover_budget_exhausted = True
                raise err
            await self._resolve()
            target = self._route(method)
            await asyncio.sleep(
                min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 2.0)

    async def oneway_async(self, method: str, payload=None) -> None:
        if self._solo is not None:
            await self._solo_bound().oneway_async(method, payload)
            return
        self._maybe_refresh()
        target = self._route(method)
        try:
            await self._pool.get(target).oneway_async(method, payload)
            return
        except RpcConnectionError:
            self._mark_dead(target)
            if len(self._known) <= 1:
                raise
        # One re-shard retry: oneways are best-effort, but a dead ring
        # replica should cost one epoch bump, not a silent drop.
        await self._resolve()
        retry = self._route(method)
        if retry == target:
            raise RpcConnectionError(
                f"no live GCS replica for oneway {method}")
        await self._pool.get(retry).oneway_async(method, payload)

    async def oneway_many(self, items) -> None:
        """Batched-oneway surface (RpcClient.oneway_many contract, used
        by the coalesced publish drain).  Solo specs ship the whole
        batch in one write; replicated specs route per item — each
        method may shard differently."""
        if self._solo is not None:
            await self._solo_bound().oneway_many(items)
            return
        for method, payload in items:
            await self.oneway_async(method, payload)

    def call(self, method: str, payload=None,
             timeout: float | None = None, retries: int = 0):
        """Blocking call from any non-io thread (RpcClient.call
        contract, including the retry semantics callers rely on)."""
        from ant_ray_tpu_torch._lint.lockcheck import note_blocking  # noqa: PLC0415

        note_blocking(f"GcsRouter.call:{method}")
        attempt = 0
        while True:
            try:
                return self._io.run_coro(
                    self.call_async(method, payload, timeout))
            except RpcConnectionError as e:
                attempt += 1
                if attempt > retries or \
                        getattr(e, "failover_budget_exhausted", False):
                    raise
                time.sleep(min(0.1 * 2 ** attempt, 2.0))

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        # The per-replica RpcClients belong to the pool and are closed
        # by it; the router itself holds no sockets.
        self._closed = True

    # ------------------------------------------------------------ surface

    def ha_view(self, timeout: float = 5.0) -> dict:
        """Convenience for status surfaces: the current HA view from
        whichever replica answers first."""
        return self.call("GetHaView", {}, timeout=timeout, retries=1)
