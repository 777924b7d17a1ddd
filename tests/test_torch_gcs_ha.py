"""The port's replicated GCS: leader + warm standbys over one shared
store — tests/test_gcs_ha.py's cases on ``ant_ray_tpu_torch``, asserting
what the JAX package's assert (ref: the GCS-FT blueprint,
src/ray/gcs/store_client/redis_store_client.h, extended to a live
replica set).

Covered here: the routing split (the same sets as the JAX package's),
NotLeader redirect round-trip, follower read-your-writes via the store
fence, standby promotion with the client router re-resolving through
GetHaView, double-leader fencing (an expired lease rejects late
mutations), sticky FAILED task state surviving a leader kill (ring
merge + producer terminal replay), failover over a remote store, the
typed store-fence error and the CLI's HA view.  The reference's leader
kill mid-``fit()`` drives a ``JaxTrainer`` and waits for the port's
trainer (ROADMAP queue A item 7).

The replicas run in this process with second-scale periods (lease 0.8
s, renew 0.15 s, sync 0.1 s): they share the GIL with the test."""

import time

import pytest

from ant_ray_tpu._private import wire_schema as jax_wire_schema
from ant_ray_tpu_torch._private import task_events, wire_schema
from ant_ray_tpu_torch._private.gcs import GcsServer
from ant_ray_tpu_torch._private.protocol import ClientPool, NotLeaderError


@pytest.fixture
def fast_ha(monkeypatch):
    """Second-scale lease/sync periods so failover runs in test time."""
    from ant_ray_tpu_torch._private.config import global_config

    cfg = global_config()
    monkeypatch.setattr(cfg, "gcs_ha_lease_ttl_s", 0.8)
    monkeypatch.setattr(cfg, "gcs_ha_renew_period_s", 0.15)
    monkeypatch.setattr(cfg, "gcs_ha_sync_period_s", 0.1)
    monkeypatch.setattr(cfg, "gcs_failover_timeout_s", 20.0)
    return cfg


def _wait(predicate, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def replica_pair(fast_ha, tmp_path):
    """Two in-process GCS replicas over one sqlite store: replicas[0]
    leads, replicas[1] stands by with a synced view of the leader."""
    store = str(tmp_path / "gcs_store.db")
    leader = GcsServer(store_path=store, ha_replica_id="ra")
    leader.start()
    assert leader._ha.wait_until_leader(10), "first replica never led"
    standby = GcsServer(store_path=store, ha_replica_id="rb")
    standby.start()
    _wait(lambda: standby._ha.leader_addr() == leader.address,
          what="standby to sync the leader ad")
    _wait(lambda: standby.address in leader._ha.peer_addresses(),
          what="leader to see the standby's ad")
    servers = [leader, standby]
    yield servers, store
    for server in servers:
        try:
            server.stop()
        except Exception:  # noqa: BLE001 — already stopped by the test
            pass
    ClientPool().close_all()


def _freeze_lease(server) -> None:
    """Simulate a partitioned/stalled leader: its renew thread stops
    (no renewals, no demote callback), but the process keeps serving —
    the exact shape of the double-leader window."""
    selector = server._ha._selector
    selector._stop.set()
    selector._thread.join(timeout=5)


# ------------------------------------------------------- routing split


def test_routing_split_covers_gcs_surface():
    """Every GCS method is exactly one of follower-read / ring-write /
    mutation, and the sets only name real GCS methods — the server
    guard and the client router both read these."""
    gcs = wire_schema.gcs_methods()
    assert wire_schema.GCS_FOLLOWER_READS <= gcs
    assert wire_schema.GCS_RING_WRITES <= gcs
    assert not (wire_schema.GCS_FOLLOWER_READS
                & wire_schema.GCS_RING_WRITES)
    mutations = wire_schema.gcs_mutations()
    assert mutations | wire_schema.GCS_FOLLOWER_READS | \
        wire_schema.GCS_RING_WRITES == gcs
    # The load-bearing members: mutations must include writes, reads
    # must include the scrape/state surface.
    assert {"KVPut", "RegisterNode", "CreateActor",
            "Heartbeat"} <= mutations
    assert {"GetAllNodes", "MetricsGet", "ListTasks",
            "SpanEventsGet", "GetHaView"} <= \
        wire_schema.GCS_FOLLOWER_READS
    # The same split as the JAX package's: a router of either package
    # sends a method to the same kind of replica.
    assert wire_schema.GCS_FOLLOWER_READS == \
        jax_wire_schema.GCS_FOLLOWER_READS
    assert wire_schema.GCS_RING_WRITES == jax_wire_schema.GCS_RING_WRITES


# --------------------------------------------- redirect + follower reads


def test_not_leader_redirect_roundtrip(replica_pair):
    """A mutation sent straight at a standby raises a typed NotLeader
    redirect naming the leader; the pooled router follows it
    transparently."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    with pytest.raises(NotLeaderError) as info:
        pool.get(standby.address).call(
            "KVPut", {"key": "k", "value": b"v"}, timeout=5)
    assert info.value.leader_addr == leader.address
    # The same mutation through the router lands (redirect absorbed).
    router = pool.get(f"{standby.address},{leader.address}")
    assert router.call("KVPut", {"key": "k", "value": b"v"},
                       timeout=10) is True
    assert leader._kv.get("k") == b"v"


def test_follower_read_your_writes_via_fence(replica_pair):
    """put-to-leader → fenced get-from-follower sees the value
    immediately (read-through the shared store), before the sync loop
    could have replicated it; the plain cached read converges within a
    sync period."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    pool.get(leader.address).call(
        "KVPut", {"key": "fresh", "value": b"rw"}, timeout=5)
    value = pool.get(standby.address).call(
        "KVGet", {"key": "fresh", "fence": True}, timeout=5)
    assert value == b"rw"
    _wait(lambda: pool.get(standby.address).call(
        "KVGet", {"key": "fresh"}, timeout=5) == b"rw",
        what="sync-loop replication of the key")


def test_follower_serves_reads_and_ha_view(replica_pair):
    """The standby answers the read surface from its synced tables and
    reports itself (with replication lag) in the HA view."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    def roles():
        view = pool.get(standby.address).call("GetHaView", {},
                                              timeout=5)
        return {r["replica_id"]: r["role"] for r in view["replicas"]}

    # Replica ads converge one sync tick after promotion — poll.
    _wait(lambda: roles() == {"ra": "leader", "rb": "standby"},
          what="replica ads to converge")
    view = pool.get(standby.address).call("GetHaView", {}, timeout=5)
    assert view["ha"] is True
    assert view["role"] == "standby"
    assert view["leader"] == leader.address
    assert view["replication_lag_s"] is not None
    # Metrics scrape off the follower: record via leader, read follower.
    pool.get(leader.address).call("MetricRecord", {
        "name": "ha_probe", "type": "gauge", "value": 7.0,
        "tags": {}}, timeout=5)
    _wait(lambda: any(
        s["name"] == "ha_probe" and s["value"] == 7.0
        for s in pool.get(standby.address).call("MetricsGet", {},
                                                timeout=5)),
        what="metrics to replicate to the follower")


# ------------------------------------------------------------ failover


def test_failover_promotes_standby_and_router_recovers(replica_pair):
    """Leader dies without releasing its lease (hard kill shape): the
    standby takes over at TTL expiry, the router re-resolves through
    GetHaView, mutations land on the new leader, and the view records
    the failover."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    router = pool.get(f"{leader.address},{standby.address}")
    assert router.call("KVPut", {"key": "pre", "value": b"1"},
                       timeout=10) is True
    _freeze_lease(leader)          # no release: the TTL must expire
    leader._server.stop()          # the listener dies with the process
    # Until the TTL expires the old leader legitimately IS the leader
    # (its lease is still valid); failover completes at expiry.
    _wait(lambda: standby._ha.is_leader_active(),
          what="standby to take the expired lease")
    assert router.call("KVPut", {"key": "post", "value": b"2"},
                       timeout=10, retries=3) is True
    assert standby._kv.get("post") == b"2"
    # Pre-failover state survived through the store.
    assert router.call("KVGet", {"key": "pre"}, timeout=10) == b"1"
    # The view converges once the surviving replicas sync the new
    # leader's ad (eventual, bounded by the sync period) — poll.
    _wait(lambda: router.call("GetHaView", {},
                              timeout=10)["leader"] == standby.address,
          what="HA view to converge on the new leader")
    view = router.call("GetHaView", {}, timeout=10)
    assert view["term"] >= 2
    assert view["last_failover_ts"] is not None


def test_double_leader_fencing_rejects_late_mutation(replica_pair):
    """The split-brain window: the old leader's lease expires while its
    process is alive and reachable.  Its late mutation must be rejected
    by the lease-validity fence (before any demote callback ran), and
    it must stop self-reporting leadership."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    _freeze_lease(leader)          # stalled renewals, server still up
    _wait(lambda: standby._ha.is_leader_active(),
          what="standby to take the expired lease")
    # Old leader is alive and reachable — but fenced.
    with pytest.raises(NotLeaderError):
        pool.get(leader.address).call(
            "KVPut", {"key": "late", "value": b"split"}, timeout=5)
    assert leader._kv.get("late") is None
    assert standby._kv.get("late") is None
    view = pool.get(leader.address).call("GetHaView", {}, timeout=5)
    assert view["role"] == "standby"


# ------------------------------------------- sticky terminal task state


def test_sticky_failed_state_survives_leader_kill(replica_pair):
    """A FAILED folded on a follower's ring shard survives the leader's
    death, reads merged through the promoted leader, and a late
    duplicate 'finished' cannot flip it (sticky terminal rank)."""
    (leader, standby), _store = replica_pair
    pool = ClientPool()
    failed = {"task_id": "t-doomed", "name": "boom", "event": "failed",
              "ts": time.time(), "attempt": 0, "job_id": "j1",
              "error": "induced"}
    # Ring write lands on the STANDBY's shard (any-replica ingestion).
    pool.get(standby.address).call(
        "TaskEventsAdd", {"events": [failed]}, timeout=5)
    # Merged view through the leader sees the follower's slice.
    reply = pool.get(leader.address).call(
        "ListTasks", {"job_id": "j1"}, timeout=10)
    assert [t["state"] for t in reply["tasks"]] == ["FAILED"]
    # Leader dies; standby promotes.
    _freeze_lease(leader)
    leader._server.stop()
    _wait(lambda: standby._ha.is_leader_active(),
          what="standby promotion")
    reply = pool.get(standby.address).call(
        "ListTasks", {"job_id": "j1"}, timeout=10)
    assert [t["state"] for t in reply["tasks"]] == ["FAILED"]
    # A late duplicate flush claiming success cannot un-fail it.
    pool.get(standby.address).call("TaskEventsAdd", {"events": [{
        "task_id": "t-doomed", "name": "boom", "event": "finished",
        "ts": time.time(), "attempt": 0, "job_id": "j1"}]}, timeout=5)
    reply = pool.get(standby.address).call(
        "GetTask", {"task_id": "t-doomed"}, timeout=10)
    assert reply["attempts"][0]["state"] == "FAILED"
    assert reply["attempts"][0]["error"] == "induced"


def test_terminal_tail_replays_on_ring_epoch_change(monkeypatch):
    """Producer-side durability: when the router's ring epoch moves (a
    replica died with its ring), the next flush replays the bounded
    terminal tail so FAILED/FINISHED records re-fold on a survivor."""
    sent = []

    class FakeGcs:
        ring_epoch = 0

    class FakeRuntime:
        _gcs = FakeGcs()
        gcs_address = "fake:1,fake:2"
        job_id = None
        address = "w:1"

        def _send_oneway(self, _addr, method, payload):
            sent.append((method, payload))

    fake = FakeRuntime()
    monkeypatch.setattr(task_events, "_runtime", lambda: fake)
    buffer = task_events.TaskEventBuffer()
    buffer.record(fake, task_id="t1", name="f", event="failed",
                  error="x")
    buffer.record(fake, task_id="t2", name="f", event="started")
    buffer.flush()
    assert len(sent) == 1
    first = sent[0][1]["events"]
    assert {e["task_id"] for e in first} == {"t1", "t2"}
    # Quiet epoch: nothing new, nothing to flush.
    buffer.flush()
    assert len(sent) == 1
    # Epoch moves (replica set changed): terminal tail replays — the
    # failed event again, NOT the non-terminal started.
    FakeGcs.ring_epoch = 1
    buffer.flush()
    assert len(sent) == 2
    replayed = sent[1][1]["events"]
    assert [e["task_id"] for e in replayed] == ["t1"]
    assert replayed[0]["event"] == "failed"


def test_failover_over_remote_store(fast_ha, tmp_path):
    """The cross-machine shape: replicas share an ``art-store://``
    service instead of a local sqlite file.  Promotion snapshots the
    tables through that store's RPC client — which blocks on the SAME
    io loop the GCS runs on, so this pins the off-loop re-hydrate
    (an inline load deadlocks the replica and no leader ever serves)."""
    from ant_ray_tpu_torch._private.store_server import StoreServer

    store_srv = StoreServer(str(tmp_path / "tables.db"))
    spec = "art-store://" + store_srv.start()
    leader = GcsServer(store_path=spec, ha_replica_id="ra")
    leader.start()
    standby = None
    try:
        assert leader._ha.wait_until_leader(15), \
            "remote-store replica never promoted"
        standby = GcsServer(store_path=spec, ha_replica_id="rb")
        standby.start()
        pool = ClientPool()
        router = pool.get(f"{leader.address},{standby.address}")
        assert router.call("KVPut", {"key": "k", "value": b"v"},
                           timeout=10) is True
        _wait(lambda: standby._ha.leader_addr() == leader.address,
              what="standby to sync the remote-store leader ad")
        leader.stop()       # graceful release: standby takes over
        _wait(lambda: standby._ha.is_leader_active(),
              what="standby promotion over the remote store")
        assert router.call("KVGet", {"key": "k"}, timeout=10,
                           retries=3) == b"v"
        assert router.call("KVPut", {"key": "k2", "value": b"w"},
                           timeout=10, retries=3) is True
    finally:
        for server in (leader, standby):
            if server is not None:
                try:
                    server.stop()
                except Exception:  # noqa: BLE001 — already stopped
                    pass
        store_srv.stop()


# ------------------------------------------------------- fence satellite


def test_store_fence_failure_raises_typed_error(monkeypatch, tmp_path):
    """A remote-store read whose fence cannot drain surfaces a typed
    StoreFenceError instead of silently returning stale state, and the
    budget is the config knob."""
    from ant_ray_tpu_torch._private.config import global_config
    from ant_ray_tpu_torch._private.store_client import (
        RemoteStoreClient,
        StoreFenceError,
    )
    from ant_ray_tpu_torch._private.store_server import StoreServer

    monkeypatch.setattr(global_config(), "store_fence_timeout_s", 0.3)
    server = StoreServer(str(tmp_path / "tables.db"))
    address = server.start()
    client = RemoteStoreClient(f"art-store://{address}")
    client.put("t", "k", b"v")
    assert client.get("t", "k") == b"v"     # fence drains: fine
    server.stop()
    client.put("t", "k2", b"unlandable")    # queued against a dead store
    try:
        with pytest.raises(StoreFenceError):
            client.get("t", "k")
    finally:
        # Abandon the unlandable write's retry loop (close() marks the
        # client so the drainer stops instead of spinning forever).
        client.close()


# ------------------------------------------------- router after failover


class _FakeReplica:
    def __init__(self, address, view=None):
        self.address, self.view, self.calls = address, view, []

    async def call_async(self, method, payload=None, timeout=None):
        self.calls.append(method)
        if self.view is None:
            raise self.dead_error(f"{self.address} refused")
        return self.view if method == "GetHaView" else b"v"


class _FakePool:
    def __init__(self, replicas):
        self.replicas = {r.address: r for r in replicas}

    def get(self, address):
        return self.replicas[address]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_router_keeps_a_refused_follower_out_of_stale_views(package,
                                                           monkeypatch):
    """The new leader's view still lists a replica that was promoted and
    killed within one sync period, as a standby (its last ad), until
    that ad ages out.  The port's router sends a follower read there
    once: the refusal keeps the replica out of the views it absorbs, so
    the read lands on the leader at once.  The JAX package's router
    takes the replica back from every view and spins on it until its
    failover budget runs out."""
    import importlib

    root = "ant_ray_tpu" if package == "jax" else "ant_ray_tpu_torch"
    gcs_client = importlib.import_module(f"{root}._private.gcs_client")
    protocol = importlib.import_module(f"{root}._private.protocol")
    config = importlib.import_module(f"{root}._private.config")
    monkeypatch.setattr(config.global_config(), "gcs_failover_timeout_s",
                        0.5)
    view = {"ha": True, "role": "leader", "leader": "L", "address": "L",
            "replicas": [{"replica_id": "r2", "address": "L",
                          "role": "leader"},
                         {"replica_id": "r1", "address": "F",
                          "role": "standby"}]}
    leader, dead = _FakeReplica("L", view), _FakeReplica("F")
    dead.dead_error = protocol.RpcConnectionError
    router = gcs_client.GcsRouter("L,F", _FakePool([leader, dead]))
    router._absorb_view(view)
    router._view_ts = time.monotonic()       # no background refresh
    assert router._route("KVGet") == "F"
    if package == "port":
        assert router.call("KVGet", {"key": "k"}, timeout=5) == b"v"
        assert dead.calls == ["KVGet"]
        assert router._route("KVGet") == "L"
        assert "F" not in router._live
    else:
        with pytest.raises(protocol.RpcConnectionError):
            router.call("KVGet", {"key": "k"}, timeout=5)
        assert dead.calls.count("KVGet") > 1


# ------------------------------------------------------------------ CLI


def test_cli_status_renders_ha_view(replica_pair, capsys):
    """`python -m ant_ray_tpu_torch status` against a replicated head reports
    leader identity, the standby set, and replication lag."""
    from ant_ray_tpu_torch import cli

    (leader, standby), _store = replica_pair
    spec = f"{leader.address},{standby.address}"
    assert cli.main(["--address", spec, "status"]) == 0
    out = capsys.readouterr().out
    assert f"leader {leader.address}" in out
    assert "standby " + standby.address in out
    assert "lag" in out
