"""The port's GCS fault tolerance: kill the head, restart it from its
sqlite store, and the cluster resumes — the three scenarios of
tests/test_gcs_ft.py on ``ant_ray_tpu_torch.cluster_utils.Cluster``,
asserting what the JAX package's asserts.

Only the port's cluster runs here: the reference's scenario has failed
now and then under load (ROADMAP, "Unsteady reference tests"), and its
cluster is not needed to hold these assertions.  Every wait has a
deadline that a loaded host meets (the restarted GCS grants restored
nodes a full heartbeat timeout before judging them)."""

import os
import signal
import time

import pytest

import ant_ray_tpu_torch as art
from ant_ray_tpu_torch.cluster_utils import Cluster
from ant_ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
)


@pytest.fixture()
def ft_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2)
    cluster.connect()
    yield cluster
    art.shutdown()
    cluster.shutdown()


def _alive_nodes():
    return len([n for n in art.nodes() if n["Alive"]])


def test_gcs_restart_resync(ft_cluster):
    from ant_ray_tpu_torch._private.worker import global_worker

    rt = global_worker.runtime

    # State before the crash: a named actor, a placement group, a KV key.
    @art.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    counter = Counter.options(name="survivor").remote()
    assert art.get(counter.incr.remote()) == 1

    pg = placement_group([{"CPU": 1}], strategy="PACK", name="ft_pg")
    assert pg.ready(timeout=30)
    rt._gcs.call("KVPut", {"key": "ft_key", "value": b"ft_value"},
                 retries=3)

    ft_cluster.kill_gcs()
    time.sleep(0.5)
    ft_cluster.restart_gcs()

    # Actor state survived the restart AND the actor process kept its
    # in-memory state (it never died — only the head did).
    assert art.get(counter.incr.remote(), timeout=60) == 2

    # Named-actor lookup, PG table, and KV resumed from the store.
    again = art.get_actor("survivor")
    assert art.get(again.incr.remote(), timeout=60) == 3
    assert rt._gcs.call("KVGet", {"key": "ft_key"}, retries=5) == b"ft_value"
    table = placement_group_table()
    assert any(e["name"] == "ft_pg" and e["state"] == "CREATED"
               for e in table.values())

    # Nodes resync via heartbeats; new work schedules normally.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if _alive_nodes() == 2:
            break
        time.sleep(0.3)
    else:
        raise AssertionError("nodes did not re-register after GCS restart")

    @art.remote
    def probe():
        return "ok"

    assert art.get(probe.remote(), timeout=60) == "ok"


def test_actor_death_during_head_downtime(ft_cluster):
    """An actor worker that dies while the head is down must not be
    restored as ALIVE forever: the daemon retries its WorkerDied report
    until the restarted head accepts it (restart machinery then runs)."""
    @art.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

    p = Phoenix.remote()
    assert art.get(p.incr.remote()) == 1
    pid = art.get(p.pid.remote())

    ft_cluster.kill_gcs()
    os.kill(pid, signal.SIGKILL)  # actor dies while head is down
    time.sleep(1.0)
    ft_cluster.restart_gcs()

    # The daemon's retried death report reaches the new head; the actor
    # restarts (max_restarts=1) and is callable again with fresh state.
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        try:
            assert art.get(p.incr.remote(), timeout=20) == 1
            break
        except Exception:  # noqa: BLE001 — restart in progress
            time.sleep(0.5)
    else:
        raise AssertionError("actor never restarted after head downtime")
    assert art.get(p.pid.remote(), timeout=20) != pid


def test_new_actors_schedulable_after_restart(ft_cluster):
    ft_cluster.kill_gcs()
    ft_cluster.restart_gcs()

    @art.remote
    class Late:
        def ping(self):
            return "pong"

    deadline = time.monotonic() + 90
    last_err = None
    while time.monotonic() < deadline:
        try:
            a = Late.remote()
            assert art.get(a.ping.remote(), timeout=30) == "pong"
            return
        except Exception as e:  # noqa: BLE001 — nodes may still resync
            last_err = e
            time.sleep(1)
    raise AssertionError(f"actor never schedulable: {last_err}")
