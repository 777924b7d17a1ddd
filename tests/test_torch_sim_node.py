"""The port's ``_private/sim_node.py`` (``StubNode``: the node daemon's
control-plane protocol in process, without workers) against the JAX
package's.  The twins of tests/test_scale_harness.py ``:37``
(``test_stub_protocol_fidelity``) and ``:135``
(``test_stub_heartbeat_failure_counter_and_recovery``) run each
package's stub against a GCS of its own package, with the reference's
assertions, and the outcomes must be equal."""

import importlib
import shutil
import time

import pytest

PACKAGES = ("ant_ray_tpu", "ant_ray_tpu_torch")


def _mods(pkg):
    return [importlib.import_module(f"{pkg}._private.{name}")
            for name in ("services", "protocol", "sim_node", "ids")]


@pytest.fixture(params=PACKAGES)
def plain_gcs(request):
    services, protocol, sim_node, ids = _mods(request.param)
    session_dir = services.new_session_dir()
    proc, address = services.start_gcs(session_dir)
    pool = protocol.ClientPool()
    env = {"pkg": request.param, "address": address, "pool": pool,
           "proc": proc, "session_dir": session_dir,
           "services": services, "StubNode": sim_node.StubNode,
           "WorkerID": ids.WorkerID}
    yield env
    pool.close_all()
    services.stop_processes([env["proc"]])
    shutil.rmtree(session_dir, ignore_errors=True)


_OUTCOMES: dict = {}


def _record(test, pkg, outcome):
    """Hold this package's outcome equal to the other's, whichever ran
    first."""
    seen = _OUTCOMES.setdefault(test, {})
    seen[pkg] = outcome
    if len(seen) == 2:
        assert seen["ant_ray_tpu"] == seen["ant_ray_tpu_torch"]


def test_stub_protocol_fidelity(plain_gcs):
    address, pool = plain_gcs["address"], plain_gcs["pool"]
    services = plain_gcs["services"]
    gcs = pool.get(address)
    daemon_proc, daemon_addr = services.start_node(
        address, {"CPU": 4.0}, plain_gcs["session_dir"])
    stub = plain_gcs["StubNode"](address, num_cpus=4.0)
    outcome = []
    try:
        stub.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            infos = gcs.call("GetAllNodes", {}, timeout=10)
            if len(infos) == 2:
                break
            time.sleep(0.1)
        infos = gcs.call("GetAllNodes", {}, timeout=10)
        assert len(infos) == 2
        by_addr = {i.address: i for i in infos.values()}
        real, fake = by_addr[daemon_addr], by_addr[stub.address]
        for field in ("node_id", "address", "total_resources",
                      "available_resources", "alive", "labels"):
            assert type(getattr(fake, field)) is \
                type(getattr(real, field)), field
        assert fake.total_resources["CPU"] == 4.0
        outcome.append(sorted(fake.total_resources.items()))

        demand = {"resources": {"CPU": 1.0}}
        for addr in (daemon_addr, stub.address):
            reply = pool.get(addr).call("LeaseWorker", dict(demand),
                                        timeout=30)
            assert "granted" in reply and "worker_id" in reply, reply
            host, _, port = reply["granted"].rpartition(":")
            assert host and port.isdigit(), reply
            returns = [pool.get(addr).call(
                "ReturnWorker", {"worker_id": reply["worker_id"]},
                timeout=10) for _ in range(2)]
            returns.append(pool.get(addr).call(
                "ReturnWorker",
                {"worker_id": plain_gcs["WorkerID"].from_random()},
                timeout=10))
            assert returns == [True, True, False]
            outcome.append((sorted(reply), returns))

        reply = pool.get(stub.address).call(
            "LeaseWorker", {"resources": {"CPU": 99.0}}, timeout=10)
        assert reply.get("infeasible") and "reason" in reply
        outcome.append(sorted(reply))

        held = pool.get(stub.address).call("LeaseWorker", dict(demand),
                                           timeout=10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            view = gcs.call("GetAllNodes", {}, timeout=10)
            avail = {i.address: i.available_resources
                     for i in view.values()}[stub.address]
            if avail.get("CPU") == 3.0:
                break
            time.sleep(0.1)
        assert avail.get("CPU") == 3.0, avail
        pool.get(stub.address).call(
            "ReturnWorker", {"worker_id": held["worker_id"]}, timeout=10)

        page = gcs.call("ListNodes", {"limit": 1}, timeout=10)
        assert len(page["nodes"]) == 1 and page["total"] == 2
        assert page["next_token"]
        rest = gcs.call("ListNodes",
                        {"limit": 10, "token": page["next_token"]},
                        timeout=10)
        assert len(rest["nodes"]) == 1 and rest["next_token"] is None
        assert {page["nodes"][0]["node_id"],
                rest["nodes"][0]["node_id"]} == \
            {i.node_id.hex() for i in infos.values()}
        alive = gcs.call("ListNodes", {"state": "ALIVE"}, timeout=10)
        assert alive["matched"] == 2
        assert gcs.call("ListNodes", {"state": "DEAD"},
                        timeout=10)["matched"] == 0
        outcome.append((sorted(page["nodes"][0]), alive["matched"]))
    finally:
        stub.stop()
        services.stop_processes([daemon_proc])
    _record("fidelity", plain_gcs["pkg"], outcome)


def test_stub_heartbeat_failure_counter_and_recovery(plain_gcs):
    address = plain_gcs["address"]
    port = int(address.rsplit(":", 1)[1])
    stub = plain_gcs["StubNode"](address, num_cpus=2.0)
    try:
        stub.start()
        deadline = time.monotonic() + 10
        while stub.stats["beats"] == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert stub.stats["beats"] > 0
        plain_gcs["proc"].kill()
        plain_gcs["proc"].wait(timeout=5)
        time.sleep(2.5)
        failures = stub.stats["failures"]
        assert 0 < failures < 20
        proc, new_address = plain_gcs["services"].start_gcs(
            plain_gcs["session_dir"], port=port)
        plain_gcs["proc"] = proc
        assert new_address == address
        beats_before = stub.stats["beats"]
        deadline = time.monotonic() + 20
        while stub.stats["beats"] <= beats_before and \
                time.monotonic() < deadline:
            time.sleep(0.2)
        assert stub.stats["beats"] > beats_before
        assert sorted(stub.stats) == sorted(
            {"beats", "views_sent", "failures", "reregisters",
             "leases_granted", "leases_infeasible", "leases_returned",
             "events_flushed", "pub_events_seen", "sub_errors"})
    finally:
        stub.stop()
    _record("recovery", plain_gcs["pkg"], sorted(stub.stats))


def test_stub_events_and_subscription_reach_the_ports_gcs():
    """Beyond the twins: the stub's task-event flushes and its SubPoll
    subscription against the port's GCS (the scale harness's other
    loads), and every RPC the stub serves or sends is in the port's
    wire schema."""
    services, protocol, sim_node, _ids = _mods("ant_ray_tpu_torch")
    from ant_ray_tpu_torch._private import wire_schema

    session_dir = services.new_session_dir()
    proc, address = services.start_gcs(session_dir)
    stub = sim_node.StubNode(address, num_cpus=1.0)
    try:
        stub.start()
        stub.start_task_event_loop(rate_hz=60.0, batch=6)
        stub.subscribe(("node",))
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
                stub.stats["events_flushed"] >= 6
                and stub.stats["beats"] >= 2):
            time.sleep(0.1)
        assert stub.stats["events_flushed"] >= 6
        assert stub.stats["sub_errors"] == 0
        for method in ("RegisterNode", "Heartbeat", "TaskEventsAdd",
                       "SubPoll", "LeaseWorker", "ReturnWorker",
                       "GetNodeInfo", "Ping"):
            assert method in wire_schema.METHODS, method
    finally:
        stub.stop()
        services.stop_processes([proc])
        shutil.rmtree(session_dir, ignore_errors=True)
