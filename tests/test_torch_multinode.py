"""Multi-node scheduling, transfer and node death in the port against the
JAX package: the twins of tests/test_multinode.py, on a three-node
``cluster_utils.Cluster`` of each package (a 1-CPU head, a 2-CPU node
with the custom resource ``special`` and a plain 2-CPU node), both built
once for the module.  Node ids are mapped to each node's tag ("head",
"special", "plain", "victim"); values, tags and exceptions (type and
masked message) must be equal.  Where the reference asserts only that
work left the driver's node, the twin asserts it for each package and
compares that verdict."""

import os
import time

import numpy as np
import pytest

from runtime_twins import PACKAGES, both, mod, node_tags, outcome, wait_for


def _three_nodes(art):
    cluster = mod(art, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 1})
    cluster.add_node(num_cpus=2, resources={"special": 1})
    cluster.add_node(num_cpus=2)
    cluster.connect()
    return cluster


@pytest.fixture(scope="module")
def clusters():
    made = {}
    try:
        for art in PACKAGES:
            made[art] = _three_nodes(art)
        yield made
    finally:
        for art, cluster in made.items():
            art.shutdown()
            cluster.shutdown()


def _tag(node) -> str:
    resources = node["Resources"]
    for name in ("special", "victim"):
        if name in resources:
            return name
    return "head" if resources.get("CPU") == 1.0 else "plain"


def test_cluster_view(clusters):
    def scenario(art):
        nodes = [n for n in art.nodes() if n["Alive"]]
        assert len(nodes) == 3
        assert art.cluster_resources()["CPU"] == 5.0
        return sorted(_tag(n) for n in nodes), art.cluster_resources()

    want, got = both(scenario)
    assert got == want
    assert got[0] == ["head", "plain", "special"]


def test_spillback_spreads_load(clusters):
    """Work leaves the driver's node (asserted for each package)."""
    def scenario(art):
        @art.remote
        def which_node(t):
            time.sleep(t)
            return os.environ["ART_NODE_ID"]

        tags = node_tags(art, _tag)
        locations = art.get([which_node.remote(0.5) for _ in range(5)])
        spread = {tags[n] for n in locations}
        assert len(spread) >= 2, (art.__name__, spread)
        return len(locations), spread <= {"head", "special", "plain"}

    want, got = both(scenario)
    assert got == want == (5, True)


def test_custom_resource_routing(clusters):
    def scenario(art):
        @art.remote(resources={"special": 1})
        def on_special():
            return os.environ["ART_NODE_ID"]

        tags = node_tags(art, _tag)
        special_node = art.get(on_special.remote())
        assert special_node   # scheduled though the head lacks "special"
        assert art.get(on_special.remote()) == special_node
        return tags[special_node]

    want, got = both(scenario)
    assert got == want == "special"


def test_infeasible_task_errors(clusters):
    def scenario(art):
        @art.remote(resources={"nonexistent": 1})
        def impossible():
            return 1

        with pytest.raises(art.exceptions.ArtError,
                           match="no node can ever"):
            art.get(impossible.remote())
        return outcome(lambda: art.get(impossible.remote()))

    want, got = both(scenario)
    assert got == want
    assert got[0] == "raise"


def test_cross_node_object_transfer(clusters):
    def scenario(art):
        @art.remote(resources={"special": 1})
        def produce():
            return np.arange(1_000_000, dtype=np.float64)  # 8 MB

        @art.remote
        def consume(arr):
            return float(arr.sum())

        ref = produce.remote()
        expected = float(np.arange(1_000_000, dtype=np.float64).sum())
        total = art.get(consume.remote(ref))
        assert total == expected
        last = art.get(ref)[-1]       # the driver's fetch pulls too
        assert last == 999_999.0
        return total, last

    want, got = both(scenario)
    assert got == want


@pytest.mark.slow
def test_node_death_marks_cluster_view(clusters):
    def scenario(art):
        cluster = clusters[art]
        victim = cluster.add_node(num_cpus=1, resources={"victim": 1})

        def alive():
            return sorted(_tag(n) for n in art.nodes() if n["Alive"])

        four = wait_for(lambda: len(alive()) == 4 and alive(), 10, 0.2)
        cluster.remove_node(victim)
        three = wait_for(lambda: len(alive()) == 3 and alive(), 30, 0.3)
        assert three, f"{art.__name__}: dead node never marked dead"
        return four, three

    want, got = both(scenario)
    assert got == want
    assert got == (["head", "plain", "special", "victim"],
                   ["head", "plain", "special"])


@pytest.mark.slow
def test_actor_on_dead_node_dies(clusters):
    def scenario(art):
        cluster = clusters[art]
        victim = cluster.add_node(num_cpus=1, resources={"victim": 1})

        @art.remote(resources={"victim": 0.5})
        class Doomed:
            def ping(self):
                return "pong"

        d = Doomed.remote()
        first = art.get(d.ping.remote())
        cluster.remove_node(victim)

        def ping_until_it_fails():
            for _ in range(100):
                art.get(d.ping.remote(), timeout=30)
                time.sleep(0.3)

        result = outcome(ping_until_it_fails)
        assert result[0] == "raise" and result[1][0] == "ActorDiedError", \
            result
        return first, result[1][0]

    want, got = both(scenario)
    assert got == want == ("pong", "ActorDiedError")
