"""The versioned resource syncer in the port against the JAX package: the
twins of tests/test_resource_syncer.py — idle beats carry no view, a
change ships a new view per version, a restarted GCS commands a resync
— on a one-node ``Cluster`` (2 CPUs) of each package, both built once
for the module.  Each reference assertion is made for each package (beat
and view counts in a window are the host's timing); the verdicts and
values must be equal."""

import time

import pytest

from runtime_twins import PACKAGES, both, mod, runtime, wait_for


@pytest.fixture(scope="module")
def clusters():
    made = {}
    try:
        for art in PACKAGES:
            made[art] = mod(art, "cluster_utils").Cluster(
                head_node_args={"num_cpus": 2})
            made[art].connect()
        yield made
    finally:
        for art, cluster in made.items():
            art.shutdown()
            cluster.shutdown()


def _pool(art):
    return mod(art, "_private.protocol").ClientPool()


def _node_client(art):
    return _pool(art).get(runtime(art).node_address)


def _gcs_client(art, cluster):
    return _pool(art).get(cluster.gcs_address)


def test_gcs_restart_commands_resync(clusters):
    """A restarted GCS holds no view versions; the node must be told to
    resync, so that scheduling never runs on an empty view."""
    def scenario(art):
        cluster = clusters[art]
        gcs = _gcs_client(art, cluster)
        time.sleep(1.0)
        cluster.kill_gcs()
        time.sleep(0.5)
        cluster.restart_gcs()

        def recovered():
            try:
                totals = gcs.call("AvailableResources", {}, timeout=5)
                return totals.get("CPU", 0.0) >= 2.0
            except Exception:  # noqa: BLE001 — head still coming up
                return False

        ok = wait_for(recovered, 20, 0.25)
        assert ok, f"{art.__name__}: restarted GCS never recovered"

        @art.remote
        def ping():
            return "pong"

        return ok, art.get(ping.remote(), timeout=30)

    want, got = both(scenario)
    assert got == want == (True, "pong")


def test_idle_beats_are_liveness_only(clusters):
    def scenario(art):
        node = _node_client(art)
        time.sleep(1.0)          # the cluster fully idle, then a window
        before = node.call("GetSyncStats", {}, timeout=10)
        time.sleep(2.0)
        after = node.call("GetSyncStats", {}, timeout=10)
        beats = after["beats"] - before["beats"]
        views = after["views_sent"] - before["views_sent"]
        assert beats >= 3, f"{art.__name__}: heartbeat stalled ({beats})"
        # At most one straggler view in the window, not one per beat.
        assert views <= 1, f"{art.__name__}: {views} views in {beats} beats"
        return beats >= 3, views <= 1

    want, got = both(scenario)
    assert got == want == (True, True)


def test_resource_change_ships_a_new_view(clusters):
    def scenario(art):
        node = _node_client(art)
        gcs = _gcs_client(art, clusters[art])
        time.sleep(1.0)
        before = node.call("GetSyncStats", {}, timeout=10)

        @art.remote
        def hold(seconds):
            time.sleep(seconds)
            return True

        def cpus():
            return gcs.call("AvailableResources", {},
                            timeout=10).get("CPU", 0.0)

        ref = hold.remote(1.0)
        # While the task holds a CPU the GCS view reflects it within a
        # couple of beats (the change wakes the sync loop early).
        allocated = wait_for(lambda: cpus() <= 1.0, 5)
        assert allocated, f"{art.__name__}: allocation never reached GCS"
        held = art.get(ref, timeout=30)
        restored = wait_for(lambda: cpus() >= 2.0, 5)
        assert restored, f"{art.__name__}: release never reached GCS"
        after = node.call("GetSyncStats", {}, timeout=10)
        views = after["views_sent"] - before["views_sent"]
        beats = after["beats"] - before["beats"]
        # Views for the changes, far fewer than beats.
        assert 1 <= views < beats, (art.__name__, views, beats)
        return allocated, held, restored, 1 <= views < beats

    want, got = both(scenario)
    assert got == want == (True, True, True, True)
