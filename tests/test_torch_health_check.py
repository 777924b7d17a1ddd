"""The port's GCS health check (``_private/gcs.py`` ``_health_check_loop``)
judges a node only on a tick that woke on time: a tick more than one
period late is the GCS's own stall, during which the node's beats
queued unread on the socket, so it judges nobody and the next tick
does.  This is a deliberate divergence from the JAX package, whose loop
judges on every tick (ROADMAP §C).  Both cases on an in-process GCS with
a short heartbeat period and a node that beats over the wire as the
node daemon does (one beat in flight, the next a period after the
reply):

* the GCS's io loop is blocked past the timeout while the node keeps
  beating: the node stays alive;
* the node's beats stop: it is marked dead after the timeout and within
  the timeout plus two periods."""

import asyncio
import threading
import time

import pytest

from ant_ray_tpu_torch._private import config as config_mod
from ant_ray_tpu_torch._private.gcs import GcsServer
from ant_ray_tpu_torch._private.ids import NodeID
from ant_ray_tpu_torch._private.protocol import RpcClient
from ant_ray_tpu_torch._private.specs import NodeInfo

PERIOD = 0.5
BEATS = 4
TIMEOUT = PERIOD * BEATS


@pytest.fixture()
def gcs(monkeypatch):
    monkeypatch.setattr(config_mod, "_global_config", config_mod.Config(
        heartbeat_period_s=PERIOD, num_heartbeats_timeout=BEATS,
        cpu_profile_hz=0.0))
    server = GcsServer()
    server.start()
    deaths = {}
    on_death = server._on_node_death

    async def record_death(node_id):
        deaths.setdefault(node_id, time.monotonic())
        await on_death(node_id)

    server._on_node_death = record_death
    server.deaths = deaths
    yield server
    server.stop()


class _Beater:
    """A node that registers and beats as the node daemon does: each
    beat waits for its reply, the next goes a period later."""

    def __init__(self, address):
        self.node_id = NodeID.from_random()
        self.client = RpcClient(address)
        self.client.call("RegisterNode", NodeInfo(
            node_id=self.node_id, address="127.0.0.1:1",
            total_resources={"CPU": 1.0},
            available_resources={"CPU": 1.0}), timeout=10)
        self.stop = threading.Event()
        self.replies = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            reply = self.client.call("Heartbeat", {"node_id": self.node_id},
                                     timeout=10)
            assert not reply.get("unknown_node")
            self.replies += 1
            self.stop.wait(PERIOD)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=15)
        self.client.close()


def test_a_stalled_gcs_keeps_a_beating_node_alive(gcs):
    node = _Beater(gcs.address)
    try:
        time.sleep(3 * PERIOD)
        assert gcs._nodes[node.node_id].alive

        async def stall():
            time.sleep(TIMEOUT + 4 * PERIOD)   # the io loop held

        asyncio.run_coroutine_threadsafe(stall(), gcs._io.loop).result(
            timeout=30)
        replies = node.replies
        time.sleep(4 * PERIOD)
        assert node.replies > replies         # beats flow again
        assert gcs._nodes[node.node_id].alive
        assert node.node_id not in gcs.deaths
        assert gcs.health_ticks_deferred >= 1
    finally:
        node.close()


def test_a_node_whose_beats_stop_dies_within_timeout_plus_two_periods(gcs):
    node = _Beater(gcs.address)
    try:
        time.sleep(3 * PERIOD)
    finally:
        node.close()
    last = gcs._last_heartbeat[node.node_id]
    deadline = time.monotonic() + TIMEOUT + 10 * PERIOD
    while node.node_id not in gcs.deaths and time.monotonic() < deadline:
        time.sleep(0.02)
    assert node.node_id in gcs.deaths, "the node was never marked dead"
    elapsed = gcs.deaths[node.node_id] - last
    assert TIMEOUT < elapsed <= TIMEOUT + 2 * PERIOD, elapsed
    assert not gcs._nodes[node.node_id].alive
