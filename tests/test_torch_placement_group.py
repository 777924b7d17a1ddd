"""The port's placement groups (``util/placement_group.py``) against the
JAX package's: the nine scenarios of tests/test_placement_group.py, each
run on a three-node ``cluster_utils.Cluster`` of each package, with equal
outcomes — where bundles land, which demands fail and with what error,
and what the table shows.  Messages are compared after the package's own
name and random ids are masked."""

import importlib
import os
import re
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart


def _pg(art):
    return importlib.import_module(art.__name__ + ".util.placement_group")


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", type(e).__name__, _mask(str(e)))


def _both(scenario):
    """The scenario's outcome through each package, after each test's
    groups were removed; the two must be equal."""
    got = []
    for art in (jart, tart):
        try:
            got.append(_outcome(lambda: scenario(art, _pg(art))))
        finally:
            _remove_all(art)
    assert got[0] == got[1], got
    return got[1]


def _remove_all(art):
    """Remove every placement group of ``art``'s cluster, so the next
    scenario finds the cluster's resources whole."""
    pg_mod = _pg(art)
    ids = importlib.import_module(art.__name__ + "._private.ids")
    worker = importlib.import_module(art.__name__ + "._private.worker")
    rt = worker.global_worker.runtime
    for pg_hex, entry in pg_mod.placement_group_table().items():
        if entry.get("state") != "REMOVED":
            try:
                rt._gcs.call("RemovePlacementGroup", {
                    "pg_id": ids.PlacementGroupID.from_hex(pg_hex)},
                    retries=3)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(e.get("state") == "REMOVED"
               for e in pg_mod.placement_group_table().values()):
            time.sleep(0.2)  # daemon-side ReturnBundle drains
            return
        time.sleep(0.1)


@pytest.fixture(scope="module")
def three_nodes():
    clusters = []
    try:
        for art in (jart, tart):
            utils = importlib.import_module(art.__name__ + ".cluster_utils")
            cluster = utils.Cluster(head_node_args={"num_cpus": 2})
            clusters.append(cluster)
            cluster.add_node(num_cpus=2)
            cluster.add_node(num_cpus=2)
            cluster.connect()
        yield
    finally:
        for art in (jart, tart):
            art.shutdown()
        for cluster in clusters:
            cluster.shutdown()


def _where(art):
    @art.remote(num_cpus=1)
    def where():
        return os.environ["ART_NODE_ID"]

    return where


def test_strict_spread_places_on_distinct_nodes(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}] * 3,
                                    strategy="STRICT_SPREAD")
        assert pg.ready(timeout=30)
        where = _where(art)
        locations = art.get([
            where.options(placement_group=pg,
                          placement_group_bundle_index=i).remote()
            for i in range(3)])
        return len(set(locations))

    assert _both(scenario) == ("ok", 3)


def test_strict_pack_places_on_one_node(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}],
                                    strategy="STRICT_PACK")
        assert pg.ready(timeout=30)
        where = _where(art)
        locations = art.get([
            where.options(placement_group=pg,
                          placement_group_bundle_index=i).remote()
            for i in range(2)])
        return len(set(locations)), pg.bundle_count

    assert _both(scenario) == ("ok", (1, 2))


def test_infeasible_strict_spread_fails(three_nodes):
    def scenario(_art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}] * 5,
                                    strategy="STRICT_SPREAD")
        return pg.ready(timeout=30)

    outcome = _both(scenario)
    assert outcome[:2] == ("raise", "RuntimeError")
    assert "STRICT_SPREAD" in outcome[2]


def test_remove_placement_group_frees_resources(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 2}] * 3, strategy="SPREAD")
        assert pg.ready(timeout=30)
        pg_mod.remove_placement_group(pg)

        @art.remote(num_cpus=2)
        def heavy():
            return 1

        return art.get([heavy.remote() for _ in range(3)])

    assert _both(scenario) == ("ok", [1, 1, 1])


def test_actor_in_placement_group(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)

        @art.remote(num_cpus=1)
        class Pinned:
            def where(self):
                return os.environ["ART_NODE_ID"]

        a = Pinned.options(placement_group=pg,
                           placement_group_bundle_index=0).remote()
        node = art.get(a.where.remote())
        bundle_node = pg.bundle_node(0)
        art.kill(a)
        return bool(node), bundle_node is not None

    assert _both(scenario) == ("ok", (True, True))


def test_pg_table(three_nodes):
    def scenario(_art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK",
                                    name="mypg")
        assert pg.ready(timeout=30)
        table = pg_mod.placement_group_table()
        (entry,) = [e for e in table.values() if e["name"] == "mypg"]
        return sorted(entry), entry["state"], entry["strategy"], \
            entry["bundles"]

    outcome = _both(scenario)
    assert outcome[1][1:] == ("CREATED", "PACK", [{"CPU": 1}])


def test_invalid_strategy():
    got = [_outcome(lambda art=art: _pg(art).placement_group(
        [{"CPU": 1}], strategy="BOGUS")) for art in (jart, tart)]
    assert got[0] == got[1]
    assert got[1][:2] == ("raise", "ValueError") and "strategy" in got[1][2]


def test_oversized_demand_vs_bundle_errors(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)

        @art.remote(num_cpus=2)
        def too_big():
            return 1

        ref = too_big.options(placement_group=pg,
                              placement_group_bundle_index=0).remote()
        try:
            art.get(ref, timeout=30)
        except art.exceptions.ArtError as e:
            return "ArtError", type(e).__name__
        return "no error"

    outcome = _both(scenario)
    assert outcome[1][0] == "ArtError"


def test_bundle_index_out_of_range(three_nodes):
    def scenario(art, pg_mod):
        pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)

        @art.remote(num_cpus=1)
        def f():
            return 1

        ref = f.options(placement_group=pg,
                        placement_group_bundle_index=5).remote()
        try:
            art.get(ref, timeout=30)
        except art.exceptions.ArtError as e:
            return type(e).__name__, "out of range" in str(e)
        return "no error"

    assert _both(scenario)[1][1] is True
