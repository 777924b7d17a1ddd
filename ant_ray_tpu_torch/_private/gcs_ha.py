"""Replicated-GCS coordination: election, sync, fencing, HA view.

Role of the reference's GCS-FT blueprint (ref:
src/ray/gcs/store_client/redis_store_client.h + the ant fork's
Redis-lease leader election, python/ray/ha/redis_leader_selector.py):
GCS state externalized to a shared store so a standby head re-hydrates
and takes over — extended here from "restart the head" to a *live*
replica set:

* one **leader** (holds the lease from ``ha/leader_selector.py``)
  applies mutations and write-throughs every table to the store;
* N **warm standbys** tail the same store on a sync loop, serve
  follower reads from their synced tables, and redirect mutations with
  a typed :class:`~ant_ray_tpu_torch._private.protocol.NotLeaderError`;
* failover is lease expiry: a standby acquires, re-hydrates, and starts
  accepting mutations — no process restarts, clients re-resolve through
  ``GetHaView`` (gcs_client.GcsRouter).

Fencing is two-layered: the selector's compare-and-swap lease rejects a
fenced ex-leader's *renewals*, and :meth:`HaCoordinator.mutation_allowed`
additionally checks the lease-validity clock before every mutation, so
an expired-but-not-yet-demoted holder rejects late writes instead of
split-braining.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import time

from ant_ray_tpu_torch._private import wire_schema
from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.protocol import NotLeaderError

logger = logging.getLogger(__name__)

_HA_TABLE = "ha"


class HaCoordinator:
    """Per-replica HA state machine, composed by ``GcsServer``.

    All io-loop state (role, ads, lag) is owned by the GCS io loop; the
    selector's poll thread only flips GIL-atomic flags and posts the
    promote sequence onto the loop.
    """

    def __init__(self, server, replica_id: str, store_spec: str):
        self._server = server
        self.replica_id = replica_id
        cfg = global_config()
        self._sync_period = cfg.gcs_ha_sync_period_s
        ttl = cfg.gcs_ha_lease_ttl_s
        renew = cfg.gcs_ha_renew_period_s
        if store_spec.startswith("art-store://"):
            from ant_ray_tpu_torch.ha.leader_selector import (  # noqa: PLC0415
                StoreBasedLeaderSelector,
            )

            self._selector = StoreBasedLeaderSelector(
                store_spec, holder_id=replica_id,
                lease_ttl_s=ttl, renew_period_s=renew)
        else:
            from ant_ray_tpu_torch.ha.leader_selector import (  # noqa: PLC0415
                FileBasedLeaderSelector,
            )

            self._selector = FileBasedLeaderSelector(
                store_spec + ".leader-lease", holder_id=replica_id,
                lease_ttl_s=ttl, renew_period_s=renew)
        # True only after the promote sequence (re-hydrate + bookkeeping)
        # completed: the selector may hold the lease while tables are
        # still loading, and mutations must wait for the full state.
        self._active = False
        self.term = 0
        self.last_failover_ts: float | None = None
        self.lag_s: float | None = None      # follower replication lag
        self._leader_ad: dict = {}           # last synced ha/leader row
        self._replica_ads: dict[str, dict] = {}
        # (token, gen) of the leader ad the last table snapshot was
        # taken under — unchanged means the store cannot have moved,
        # so the follower skips the full re-read.
        self._synced_gen: tuple | None = None
        self._sync_task = None

    # ------------------------------------------------------- role / fence

    @property
    def role(self) -> str:
        return "leader" if self.is_leader_active() else "standby"

    def is_leader_active(self) -> bool:
        """Leadership fence: holding the role is not enough — the lease
        must still be inside its validity window, so an ex-leader whose
        lease expired (partition, stalled renew thread) stops acting —
        rejecting late mutations, dropping its self-redirect, reporting
        itself standby — even before the poll thread demotes it."""
        return (self._active and self._selector.is_leader()
                and time.monotonic() < self._selector.lease_valid_until)

    def mutation_allowed(self) -> bool:
        return self.is_leader_active()

    def leader_addr(self) -> str:
        """Best-known leader address for NotLeader redirects ('' when
        no leader is known — e.g. mid-election, or the advertised
        leader stopped refreshing its ad and is presumed dead)."""
        if self.is_leader_active():
            return self._server.address
        ad = self._leader_ad
        addr = ad.get("address", "")
        if addr == self._server.address:
            return ""        # our own stale ad from before a demotion
        # artlint: disable=banned-apis — the ad's ts is a cross-process
        # wire field (leader-written, follower-read); wall clock is the
        # only clock they share.
        if time.time() - float(ad.get("ts") or 0.0) > \
                self._stale_cutoff_s():
            return ""        # dead leader's last ad: don't redirect to it
        return addr

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._selector.on_promote = self._on_promote
        self._selector.on_demote = self._on_demote
        self._sync_task = asyncio.run_coroutine_threadsafe(
            self._sync_loop(), self._server._io.loop)
        self._selector.start()

    def stop(self) -> None:
        if self._sync_task is not None:
            self._sync_task.cancel()
        self._active = False
        # Releases a held lease so standbys take over immediately
        # instead of waiting out the TTL.
        self._selector.stop()

    def wait_until_leader(self, timeout: float | None = None) -> bool:
        if not self._selector.wait_until_leader(timeout):
            return False
        deadline = time.monotonic() + (timeout or 30.0)
        while not self._active and time.monotonic() < deadline:
            time.sleep(0.02)
        return self._active

    # ------------------------------------------------- promotion/demotion

    def _on_promote(self) -> None:       # selector thread
        asyncio.run_coroutine_threadsafe(self._promote(),
                                         self._server._io.loop)

    def _on_demote(self) -> None:        # selector thread
        self._active = False
        logger.warning("GCS replica %s fenced out of leadership",
                       self.replica_id)

    async def _promote(self):
        server = self._server
        if not self._selector.is_leader() or self._active:
            return
        previous = dict(self._leader_ad)
        # Snapshot OFF the io loop: a remote store's reads (and their
        # read fence) block on this very loop, so an inline load would
        # deadlock the whole replica.  Application + activation happen
        # back on the loop in one step, so handlers observe either the
        # pre-promotion synced tables or the complete reload, never a
        # half-applied mix.  A store blip must NOT leave us holding the
        # lease while refusing mutations forever — retry while held.
        while True:
            try:
                snap, term = await asyncio.to_thread(
                    lambda: (server._snapshot_tables_from_store(),
                             self._ha_get_int("term")))
                break
            except Exception:  # noqa: BLE001 — store blip mid-promotion
                logger.exception("promotion re-hydrate failed; retrying")
                await asyncio.sleep(self._sync_period)
                if not self._selector.is_leader():
                    return          # lost the lease while retrying
        if not self._selector.is_leader():
            return                  # fenced while snapshotting
        server._activate_tables(snap)
        self.term = term + 1
        self._ha_put("term", self.term)
        if previous and previous.get("token") != \
                self._selector.fencing_token():
            # A different holder led before us — this promotion IS a
            # failover (first-ever election is not).
            self.last_failover_ts = time.time()
        self.lag_s = None
        self._active = True
        self.write_leader_ad()
        logger.warning(
            "GCS replica %s promoted to leader (term %d%s)",
            self.replica_id, self.term,
            ", failover" if self.last_failover_ts else ", first election")

    # ------------------------------------------------------ store plumbing

    def _ha_put(self, key: str, value) -> None:
        self._server._store.put(_HA_TABLE, key, pickle.dumps(value))

    def _ha_get(self, key: str):
        blob = self._server._store.get(_HA_TABLE, key)
        return pickle.loads(blob) if blob else None

    def _ha_get_int(self, key: str) -> int:
        try:
            return int(self._ha_get(key) or 0)
        except Exception:  # noqa: BLE001 — corrupt counter: restart at 0
            return 0

    def write_leader_ad(self) -> None:
        """Leader heartbeat into the store: address for redirects/
        re-resolve, a fresh wall-clock ts for follower lag measurement,
        and the failover bookkeeping followers mirror into their views.
        Called at promotion and from the leader's flush loop."""
        if not self.is_leader_active():
            return
        self._ha_put("leader", {
            "address": self._server.address,
            "replica_id": self.replica_id,
            "token": self._selector.fencing_token(),
            "term": self.term,
            "last_failover_ts": self.last_failover_ts,
            # Store generation: followers re-read the tables only when
            # this moved (keyed with the token — a new leader's counter
            # restarts, so the pair changes across failovers).
            "gen": self._server._store_gen,
            "ts": time.time(),
        })

    def _stale_cutoff_s(self) -> float:
        cfg = global_config()
        return max(5 * cfg.gcs_ha_sync_period_s,
                   2 * cfg.gcs_ha_lease_ttl_s)

    # ------------------------------------------------------------ syncing

    async def _sync_loop(self):
        """Every replica: advertise itself and refresh the peer view;
        standbys additionally re-hydrate their tables from the store
        (the warm part of "warm standby")."""
        while True:
            try:
                await self._sync_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — store blip: retry next tick
                logger.exception("HA sync iteration failed")
            await asyncio.sleep(self._sync_period)

    async def _sync_once(self):
        server = self._server
        follower = not self.is_leader_active()

        def _store_side():
            self._ha_put("replica:" + self.replica_id, {
                "replica_id": self.replica_id,
                "address": server.address,
                "role": self.role,
                "lag_s": self.lag_s,
                "ts": time.time(),
            })
            ads = {}
            for key, blob in server._store.load_table(_HA_TABLE).items():
                if not key.startswith("replica:"):
                    continue
                try:
                    ads[key[len("replica:"):]] = pickle.loads(blob)
                except Exception:  # noqa: BLE001 — torn ad: skip
                    pass
            leader_ad = self._ha_get("leader") or {}
            tables = None
            if follower:
                # Re-read the tables only when the leader's store
                # generation moved (or the ad predates generations) —
                # an idle cluster's sync is then O(ads), not O(state).
                gen_key = (leader_ad.get("token"), leader_ad.get("gen"))
                if leader_ad.get("gen") is None or \
                        gen_key != self._synced_gen:
                    tables = server._snapshot_tables_from_store()
            return ads, leader_ad, tables

        ads, leader_ad, tables = await asyncio.to_thread(_store_side)
        self._replica_ads = ads
        if self.is_leader_active():
            return                      # promoted mid-snapshot: discard
        self._leader_ad = leader_ad
        if tables is not None:
            server._apply_table_snapshot(tables)
            self._synced_gen = (leader_ad.get("token"),
                                leader_ad.get("gen"))
        ad_ts = leader_ad.get("ts")
        if ad_ts:
            # artlint: disable=banned-apis — the leader ad's ts is a
            # CROSS-PROCESS wire field (written by the leader, read by
            # every follower); wall clock is the only clock they share.
            self.lag_s = max(0.0, time.time() - ad_ts)
        self.term = int(leader_ad.get("term", self.term) or 0)
        if leader_ad.get("last_failover_ts"):
            self.last_failover_ts = leader_ad["last_failover_ts"]

    # ------------------------------------------------------------ surface

    def view(self) -> dict:
        now = time.time()
        cutoff = self._stale_cutoff_s()
        replicas = []
        for ad in self._replica_ads.values():
            # artlint: disable=banned-apis — replica-ad ts is a cross-
            # process wire field (see the sync-loop note above).
            age = max(0.0, now - float(ad.get("ts") or 0.0))
            if age > cutoff:
                continue                 # dead replica's last ad
            replicas.append({
                "replica_id": ad.get("replica_id"),
                "address": ad.get("address"),
                "role": ad.get("role"),
                "lag_s": ad.get("lag_s"),
                "age_s": age,
            })
        replicas.sort(key=lambda r: (r["role"] != "leader",
                                     str(r["replica_id"])))
        return {
            "ha": True,
            "role": self.role,
            "replica_id": self.replica_id,
            "address": self._server.address,
            "leader": self.leader_addr(),
            "term": self.term,
            "last_failover_ts": self.last_failover_ts,
            "replication_lag_s": self.lag_s,
            "replicas": replicas,
        }

    def peer_addresses(self) -> list[str]:
        """Live peer replica addresses (self excluded) — the ring-merge
        fan-out set."""
        now = time.time()
        cutoff = self._stale_cutoff_s()
        out = []
        for ad in self._replica_ads.values():
            addr = ad.get("address")
            # artlint: disable=banned-apis — replica-ad ts: cross-
            # process wire field (see the sync-loop note above).
            if addr and addr != self._server.address and \
                    now - float(ad.get("ts") or 0.0) <= cutoff:
                out.append(addr)
        return out

    async def gather_ring(self, method: str, payload: dict) -> list:
        """Query-time merge fan-out: ask every live peer replica for its
        LOCAL slice of a sharded ring (``local_only=True`` stops the
        recursion) and return the successful replies.  A dead peer's
        slice is simply absent — the rings are bounded best-effort
        buffers; durability of the critical records (terminal task
        states) comes from producer-side replay, not from here."""
        peers = self.peer_addresses()
        if not peers:
            return []

        async def one(addr):
            try:
                return await self._server._clients.get(addr).call_async(
                    method, {**(payload or {}), "local_only": True},
                    timeout=5)
            except Exception:  # noqa: BLE001 — peer down/restarting
                return None

        replies = await asyncio.gather(*[one(a) for a in peers])
        return [r for r in replies if r is not None]

    # ------------------------------------------------------------- guard

    def guard_routes(self, handlers: dict) -> dict:
        """Wrap every leader-only method with the mutation fence; reads
        and ring writes pass through (served by any replica).  The
        split comes from wire_schema so server and client router can
        never disagree."""
        mutations = wire_schema.gcs_mutations()
        out = {}
        for method, handler in handlers.items():
            if method in mutations:
                out[method] = self._guarded(handler)
            else:
                out[method] = handler
        return out

    def _guarded(self, handler):
        async def guarded(payload):
            if not self.mutation_allowed():
                raise NotLeaderError(self.leader_addr())
            return await handler(payload)

        return guarded
