"""The port's shared-store HA: its RPC'd store service lets a STANDBY
head — on a different machine in production, a different process/port
here — restore the cluster tables and take leadership.  The four cases
of tests/test_ha_store.py on ``ant_ray_tpu_torch`` (ref:
src/ray/gcs/store_client/redis_store_client.h + the ant fork's
Redis-lease election, ha/redis_leader_selector.py:90)."""

import subprocess
import sys
import time

import pytest

from ant_ray_tpu_torch._private.protocol import find_free_port
from ant_ray_tpu_torch._private.store_client import RemoteStoreClient
from ant_ray_tpu_torch._private.store_server import StoreServer
from ant_ray_tpu_torch.ha.leader_selector import StoreBasedLeaderSelector


@pytest.fixture()
def store_server(tmp_path):
    server = StoreServer(str(tmp_path / "tables.db"))
    address = server.start()
    yield address
    server.stop()


def test_remote_store_round_trip(store_server):
    client = RemoteStoreClient(f"art-store://{store_server}")
    client.put("actors", "a1", b"alpha")
    client.put("actors", "a2", b"beta")
    client.put("jobs", "j1", b"gamma")
    assert client.get("actors", "a1") == b"alpha"
    assert client.load_table("actors") == {"a1": b"alpha",
                                           "a2": b"beta"}
    client.delete("actors", "a1")
    assert client.get("actors", "a1") is None
    assert client.load_table("jobs") == {"j1": b"gamma"}


def test_standby_head_restores_tables_from_store(store_server, tmp_path):
    """Two GCS processes, different ports (different 'machines'), same
    store service: KV and job state written through head A is readable
    from head B started after A died."""
    from ant_ray_tpu_torch._private.protocol import ClientPool
    from ant_ray_tpu_torch._private import services

    spec = f"art-store://{store_server}"
    env_args = ["--store", spec]

    def start_head(port):
        proc = subprocess.Popen(
            [sys.executable, "-m", "ant_ray_tpu_torch._private.gcs",
             "--port", str(port), *env_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for _ in range(20):            # log lines may precede READY
            line = proc.stdout.readline().decode()
            if "GCS_READY" in line:
                return proc
        raise AssertionError("GCS never became ready")

    port_a = find_free_port()
    head_a = start_head(port_a)
    pool = ClientPool()
    gcs_a = pool.get(f"127.0.0.1:{port_a}")
    gcs_a.call("KVPut", {"key": "ha-key", "value": b"survives"},
               retries=3)
    time.sleep(0.3)     # let the async write-through reach the store
    head_a.kill()
    head_a.wait(timeout=10)

    port_b = find_free_port()
    head_b = start_head(port_b)
    try:
        gcs_b = pool.get(f"127.0.0.1:{port_b}")
        assert gcs_b.call("KVGet", {"key": "ha-key"},
                          retries=3) == b"survives"
    finally:
        head_b.kill()
        head_b.wait(timeout=10)


def test_store_lease_failover_and_fencing(store_server):
    """Leader election over the store: the standby takes over once the
    leader stops renewing, and the fenced ex-leader's renewals are
    rejected (it must step down, not split-brain)."""
    a = StoreBasedLeaderSelector(store_server, holder_id="head-A",
                                 lease_ttl_s=0.6, renew_period_s=0.15)
    b = StoreBasedLeaderSelector(store_server, holder_id="head-B",
                                 lease_ttl_s=0.6, renew_period_s=0.15)
    a.start()
    assert a.wait_until_leader(timeout=5)
    b.start()
    time.sleep(0.5)
    assert not b.is_leader(), "standby grabbed a live lease"

    # Leader dies (stops renewing, never releases).
    a._stop.set()
    a._thread.join(timeout=5)
    assert b.wait_until_leader(timeout=5), "standby never took over"

    # The ex-leader's token is fenced now.
    assert a._renew() is False
    b.stop()


def test_fenced_leader_steps_down(store_server):
    """A leader whose lease was usurped (e.g. it was partitioned past
    the TTL) must drop its role on the next renew attempt."""
    a = StoreBasedLeaderSelector(store_server, holder_id="head-A",
                                 lease_ttl_s=0.4, renew_period_s=0.1)
    a.start()
    assert a.wait_until_leader(timeout=5)
    # Simulate a partition: freeze A's renewals until the lease expires,
    # then B takes the lease.
    a._stop.set()
    a._thread.join(timeout=5)
    b = StoreBasedLeaderSelector(store_server, holder_id="head-B",
                                 lease_ttl_s=5.0, renew_period_s=0.1)
    b.start()
    assert b.wait_until_leader(timeout=5)
    # A comes back from the partition and resumes its loop: its first
    # renew fails (token fenced) and it must stand by.
    a._stop.clear()
    a.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and a.is_leader():
        time.sleep(0.05)
    assert not a.is_leader(), "fenced ex-leader kept acting as leader"
    a.stop()
    b.stop()
