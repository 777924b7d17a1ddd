"""The port's flow insight (ant ref: python/ray/util/insight.py): the same
calls, made on a cluster of each package started with ``enable_insight``,
give the same call graph — tests/test_insight.py's scenario held against
the JAX package.  The clusters run one after the other (both read the
same ``ART_*`` variables).

One deliberate divergence: the port also records the submit of an actor
call, so a cluster that serves from actors shows its driver-to-actor
edges; the JAX package records submits of tasks only."""

import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


def _insight(art):
    return __import__(f"{art.__name__}.util.insight",
                      fromlist=["build_call_graph"])


def _short(name):
    return name.split(".")[-1]


def _events_until(insight, want, timeout=30.0):
    """The ring's events once ``want(events)`` holds (oneway records
    land a moment after the calls return)."""
    deadline = time.monotonic() + timeout
    while True:
        events = insight.get_flow_events()
        if want(events) or time.monotonic() > deadline:
            return events
        time.sleep(0.2)


def _count(events, kind, name):
    return sum(e["type"] == kind and _short(e["function"]) == name
               for e in events)


def _scenario_recorded(events):
    """Every record the assertions read: the submits land by oneway RPC
    from the calling process and the begins and ends from the workers,
    so any of them may still be in flight when the calls have
    returned."""
    return all(_count(events, kind, name) >= n
               for kind in ("call_submit", "call_begin", "call_end")
               for name, n in (("traced", 3), ("failing", 1)))


def _task_scenario(art):
    art.init(num_cpus=2, _system_config={"enable_insight": True})
    try:
        insight = _insight(art)

        @art.remote
        def traced(x):
            return x + 1

        @art.remote
        def failing():
            raise ValueError("nope")

        assert art.get([traced.remote(i) for i in range(3)],
                       timeout=120) == [1, 2, 3]
        with pytest.raises(Exception):
            art.get(failing.remote(), timeout=120)
        events = _events_until(insight, _scenario_recorded)
        graph = insight.build_call_graph(events)
        return {
            "kinds": sorted({e["type"] for e in events}),
            "edges": sorted((e["caller"], _short(e["callee"]), e["count"])
                            for e in graph["edges"]),
            "functions": {_short(name): (s["calls"], s["errors"])
                          for name, s in graph["functions"].items()},
        }
    finally:
        art.shutdown()


def test_flow_insight_call_graph_matches_the_jax_package():
    jax_graph, port_graph = [_task_scenario(art) for art in PACKAGES]
    assert port_graph == jax_graph
    assert {"call_submit", "call_begin", "call_end"} <= set(
        port_graph["kinds"])
    assert port_graph["functions"]["traced"] == (3, 0)
    assert port_graph["functions"]["failing"] == (1, 1)
    assert ("driver", "traced", 3) in port_graph["edges"]
    assert ("driver", "failing", 1) in port_graph["edges"]


def test_actor_calls_are_driver_to_actor_edges():
    """Each call of an actor's method is one submit from the driver: the
    graph's edge counts them, and its function stats count their runs."""
    tart.init(num_cpus=2, _system_config={"enable_insight": True})
    try:
        from ant_ray_tpu_torch.util import insight

        @tart.remote
        class Engine:
            def generate(self, n):
                return list(range(n))

        engine = Engine.remote()
        assert tart.get([engine.generate.remote(i) for i in range(4)],
                        timeout=120) == [[], [0], [0, 1], [0, 1, 2]]
        events = _events_until(insight, lambda evs: sum(
            e["type"] == "call_end" for e in evs) >= 4)
        graph = insight.build_call_graph(events)
        assert {"caller": "driver", "callee": "Engine.generate",
                "count": 4} in graph["edges"]
        assert graph["functions"]["Engine.generate"]["calls"] == 4
    finally:
        tart.shutdown()
