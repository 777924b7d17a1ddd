"""Task events, the Chrome trace and the OTel spans derived from them in
the port against the JAX package: the twins of tests/test_timeline.py,
in an ``init(num_cpus=2)`` cluster of each package.  Event kinds and
their counts for each task, the parent link of a nested task, the trace's
phases and the spans' linkage must be equal."""

import json
import time
from collections import Counter

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import both, mod


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=2, num_tpus=0)
    try:
        tart.init(num_cpus=2, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _events_for(art, name, deadline_s=20):
    fetch = mod(art, "util.timeline").fetch_task_events
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        # The task's own name: "outer_parent" is not "parent".
        events = [e for e in fetch() if e["name"].split(".")[-1] == name]
        kinds = {e["event"] for e in events}
        if {"submitted", "started"} <= kinds and \
                ({"finished"} & kinds or {"failed"} & kinds):
            return events
        time.sleep(0.3)
    raise AssertionError(f"{art.__name__}: no complete event set for {name}")


def _kinds(events) -> dict:
    return dict(Counter(e["event"] for e in events))


def test_lifecycle_events_reach_gcs(clusters):
    def scenario(art):
        @art.remote
        def traced_task(x):
            return x + 1

        value = art.get(traced_task.remote(1))
        events = _events_for(art, "traced_task")
        assert {"submitted", "started", "finished"} <= set(_kinds(events))
        started = next(e for e in events if e["event"] == "started")
        assert started["pid"] > 0 and started["node_id"]
        return value, _kinds(events)

    want, got = both(scenario)
    assert got == want
    assert got[0] == 2


def test_failed_task_records_failed_event(clusters):
    def scenario(art):
        @art.remote
        def exploding():
            raise ValueError("boom")

        with pytest.raises(Exception, match="boom"):
            art.get(exploding.remote())
        events = _events_for(art, "exploding")
        assert any(e["event"] == "failed" for e in events)
        return _kinds(events)

    want, got = both(scenario)
    assert got == want


def test_nested_task_records_parent(clusters):
    def scenario(art):
        @art.remote
        def inner_leaf():
            return 1

        @art.remote
        def outer_parent():
            return art.get(inner_leaf.remote())

        value = art.get(outer_parent.remote())
        inner = _events_for(art, "inner_leaf")
        outer = _events_for(art, "outer_parent")
        submitted = next(e for e in inner if e["event"] == "submitted")
        assert submitted["parent_task_id"] == outer[0]["task_id"]
        return value, _kinds(inner), _kinds(outer)

    want, got = both(scenario)
    assert got == want
    assert got[0] == 1


def test_chrome_trace_export(clusters, tmp_path):
    def scenario(art):
        @art.remote
        def slice_me():
            time.sleep(0.05)
            return "ok"

        value = art.get(slice_me.remote())
        _events_for(art, "slice_me")
        path = art.timeline(str(tmp_path / f"{art.__name__}.json"))
        with open(path) as f:
            trace = json.load(f)
        slices = [t for t in trace if t["ph"] == "X"
                  and t["name"].endswith("slice_me")]
        assert slices and slices[0]["dur"] >= 50_000 * 0.5   # >= ~25 ms
        phases = {t["ph"] for t in trace}
        assert {"s", "f"} <= phases          # submit flow arrows
        return value, len(slices), sorted(phases & {"X", "s", "f"})

    want, got = both(scenario)
    assert got == want
    assert got == ("ok", 1, ["X", "f", "s"])


def test_otel_spans_derived_from_events(clusters):
    """Spans with trace and parent linkage, and their OTLP export.  The
    parent is submitted under an unsampled context: at the default
    sample rate (0.01) a head-sampled submission turns both tasks into
    propagated spans (``run:``, ``call:``), which carry no
    ``art.queue_time_s`` and link the child to a call span, so the
    derived spans under test would be missing one run in a hundred."""
    def scenario(art):
        tracing = mod(art, "util.tracing")
        plane = mod(art, "observability.tracing_plane")

        @art.remote
        def child(x):
            return x + 1

        @art.remote
        def parent():
            return art.get(child.remote(1))

        with plane.use(plane.mint(sampled=False)):
            value = art.get(parent.remote())
        _events_for(art, "child")
        _events_for(art, "parent")
        spans = tracing.task_spans()
        assert any("child" in s.name for s in spans), [s.name for s in spans]
        child_span = next(s for s in spans if "child" in s.name)
        parents = [s for s in spans if "parent" in s.name
                   and s.span_id == child_span.parent_span_id]
        assert parents, (art.__name__, child_span, [
            (s.name, s.span_id, s.trace_id) for s in spans])
        parent_span = parents[0]
        # Same trace, linked, the child nested within the parent's time.
        assert child_span.trace_id == parent_span.trace_id
        assert child_span.start_ns >= parent_span.start_ns
        assert child_span.end_ns >= child_span.start_ns
        assert "art.queue_time_s" in child_span.attributes
        payload = tracing.export_otlp_json()
        wire = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert len(wire) == len(spans)
        assert all(len(w["traceId"]) == 32 and len(w["spanId"]) == 16
                   for w in wire)
        return value, sorted(child_span.attributes), \
            parent_span.name.split(".")[-1]

    want, got = both(scenario)
    assert got == want
    assert got[0] == 2
