"""The request tracing plane (``observability/tracing_plane.py``) in the
port against the JAX package: the twins of tests/test_tracing_plane.py
that tests/test_torch_tracing.py does not already hold (its
``test_spans_and_otlp_equal_the_reference`` twins ``:175``
``test_attempt_salted_span_ids`` and ``:204``
``test_task_spans_folds_live_spans_single_code_path``).

* Units: contexts minted, derived, pickled and read across the two
  packages' wire forms; the sample rate; the flight recorder's rings; the
  span tree; a Serve handle's bound context.
* A two-node trace: a traced task pinned to a second node pulls a
  head-owned object, and its execution and pull spans land on that node
  under the driver's trace.  The twin waits for every span it asserts
  on; the reference waits for the pull span only, while it asserts on
  the worker's run span too, which another process publishes on its own
  flush (ROADMAP, the unsteady list).
* A traced cluster with its dashboard (``ART_TRACE_SAMPLE_RATE=1.0``):
  one Serve request as one trace across processes and one tree from
  ``/api/trace/{id}``; the Chrome trace's request rows and OTLP; the
  flight recorder endpoint; the RPC histogram's exemplars in OpenMetrics;
  force-sampled shed and deadline spans; series expiry.  Each package's
  cluster runs every scenario in the reference's order, one package
  after the other (the sample rate and ``include_dashboard`` reach the
  processes as ``ART_*`` variables, which both packages read); the tests
  then hold the two outcomes equal."""

import json
import os
import pickle
import threading
import time
import urllib.request

import numpy as np
import pytest

from runtime_twins import IDS, PACKAGES, both, mod, outcome, runtime


def _plane(art):
    return mod(art, "observability.tracing_plane")


# ---------------------------------------------------------------- units


def test_context_mint_child_and_pickle():
    def scenario(art):
        tp = _plane(art)
        ctx = tp.mint(sampled=True)
        assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
        child = ctx.child()
        assert child.trace_id == ctx.trace_id
        assert child.span_id != ctx.span_id and child.sampled
        flags = []
        for flag in (True, False):    # the flag survives pickling
            c = tp.mint(sampled=flag)
            c2 = pickle.loads(pickle.dumps(c))
            assert (c2.trace_id, c2.span_id, c2.sampled) == \
                (c.trace_id, c.span_id, c.sampled)
            flags.append(c2.sampled)
        assert tp.TraceContext.from_wire(ctx.to_wire()).to_wire() == \
            ctx.to_wire()
        assert tp.TraceContext.from_wire(None) is None
        return flags, ctx.to_wire()

    (jflags, jwire), (tflags, twire) = both(scenario)
    assert tflags == jflags == [True, False]
    # Each package reads the other's wire form to the same context.
    for wire, reader in ((jwire, PACKAGES[1]), (twire, PACKAGES[0])):
        assert _plane(reader).TraceContext.from_wire(wire).to_wire() == wire


def test_mint_respects_sample_rate():
    def scenario(art):
        tp = _plane(art)
        cfg = mod(art, "_private.config").global_config()
        old = cfg.trace_sample_rate
        try:
            cfg.trace_sample_rate = 0.0
            none = not any(tp.mint().sampled for _ in range(50))
            cfg.trace_sample_rate = 1.0
            every = all(tp.mint().sampled for _ in range(50))
        finally:
            cfg.trace_sample_rate = old
        return none, every

    want, got = both(scenario)
    assert got == want == (True, True)


@pytest.fixture
def fresh_recorders(monkeypatch):
    recorders = {}
    for art in PACKAGES:
        tp = _plane(art)
        recorders[art] = tp.FlightRecorder(size=64)
        monkeypatch.setattr(tp, "_recorder", recorders[art])
    return recorders


def test_unsampled_span_records_nothing(fresh_recorders):
    def scenario(art):
        tp = _plane(art)
        with tp.use(tp.mint(sampled=False)):
            with tp.span("quiet"):
                pass
        return fresh_recorders[art].snapshot()

    want, got = both(scenario)
    assert got == want == []


def test_no_context_span_is_noop(fresh_recorders):
    def scenario(art):
        tp = _plane(art)
        assert tp.current() is None
        with tp.span("nothing"):
            pass
        return fresh_recorders[art].snapshot()

    want, got = both(scenario)
    assert got == want == []


def test_error_span_force_sampled_even_unsampled(fresh_recorders):
    def scenario(art):
        tp = _plane(art)
        ctx = tp.mint(sampled=False)
        with pytest.raises(ValueError):
            with tp.use(ctx):
                with tp.span("boom", {"k": "v"}):
                    raise ValueError("x")
        spans = fresh_recorders[art].snapshot()
        assert len(spans) == 1 and spans[0]["trace_id"] == ctx.trace_id
        s = spans[0]
        return (s["error"], s["forced"], s["name"], s["attrs"],
                sorted(s))

    want, got = both(scenario)
    assert got == want
    assert got[:4] == (True, True, "boom", {"k": "v"})


def test_ring_wrap_preserves_force_sampled(fresh_recorders):
    """A flood of sampled spans wrapping the main ring does not evict
    the force-sampled error span, which lives in its own ring."""
    def scenario(art):
        tp, rec = _plane(art), fresh_recorders[art]
        tp.record_span(tp.mint(sampled=False), "the-failure",
                       ts=time.time(), dur_s=0.01, error=True)
        ok_ctx = tp.mint(sampled=True)
        for i in range(rec.size * 3):        # wrap the main ring 3x
            tp.record_span(ok_ctx, f"ok-{i}", ts=time.time(), dur_s=0.0)
        names = {s["name"] for s in rec.snapshot()}
        return "the-failure" in names, "ok-0" in names, len(names)

    want, got = both(scenario)
    assert got == want
    assert got[:2] == (True, False)


def test_span_tree_folding():
    spans = [
        {"trace_id": "t", "span_id": "a", "parent_id": "", "ts": 1.0,
         "name": "root"},
        {"trace_id": "t", "span_id": "b", "parent_id": "a", "ts": 2.0,
         "name": "child"},
        {"trace_id": "t", "span_id": "c", "parent_id": "b", "ts": 3.0,
         "name": "grandchild"},
        {"trace_id": "t", "span_id": "d", "parent_id": "missing",
         "ts": 4.0, "name": "orphan"},
    ]
    want, got = both(lambda art: _plane(art).span_tree(
        [dict(s) for s in spans]))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert [r["name"] for r in got] == ["root", "orphan"]
    assert got[0]["children"][0]["name"] == "child"
    assert got[0]["children"][0]["children"][0]["name"] == "grandchild"


def test_handle_pickle_keeps_sampling_flag():
    """A handle bound to a trace context and pickled into a downstream
    deployment keeps the context and its sampled flag."""
    def scenario(art):
        tp = _plane(art)
        handle_cls = mod(art, "serve.api").DeploymentHandle
        ctx = tp.mint(sampled=True)
        h2 = pickle.loads(pickle.dumps(handle_cls(
            "dep", [], controller=None, trace_ctx=ctx)))
        assert h2._trace_ctx is not None
        assert h2._trace_ctx.trace_id == ctx.trace_id
        assert h2._trace_root().trace_id == ctx.trace_id
        h3 = pickle.loads(pickle.dumps(handle_cls(
            "dep", [], controller=None, trace_ctx=tp.mint(sampled=False))))
        return h2._trace_ctx.sampled, h3._trace_ctx.sampled

    want, got = both(scenario)
    assert got == want == (True, False)


# --------------------------------------------------------- cluster spans


def _gcs_spans(art, predicate=None, timeout=20.0, **payload):
    """The GCS's span ring, polled until ``predicate(spans)`` holds (a
    process publishes its spans on a ~1 s age flush)."""
    tp = _plane(art)
    deadline = time.monotonic() + timeout
    while True:
        tp.flush()
        spans = runtime(art)._gcs.call(
            "SpanEventsGet", dict({"limit": 50000}, **payload), retries=3)
        if predicate is None or predicate(spans) \
                or time.monotonic() > deadline:
            return spans
        time.sleep(0.3)


class _SampleAll:
    """``ART_TRACE_SAMPLE_RATE=1.0`` for ``art``'s processes and its
    driver's config, undone after."""

    def __init__(self, art):
        self.config = mod(art, "_private.config")

    def __enter__(self):
        for art in PACKAGES:
            _plane(art).flush()
        os.environ["ART_TRACE_SAMPLE_RATE"] = "1.0"
        self.config._global_config = None

    def __exit__(self, *exc):
        os.environ.pop("ART_TRACE_SAMPLE_RATE", None)
        self.config._global_config = None


def _two_node_trace(art):
    cluster = mod(art, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 1})
    second = cluster.add_node(num_cpus=1)
    try:
        cluster.connect()
        target = next(n["NodeID"] for n in art.nodes()
                      if n["Address"] == second)
        blob_ref = art.put(np.ones(400_000, dtype=np.uint8))

        @art.remote
        def consume(arr):
            return int(arr.sum())           # arg auto-fetch = the pull

        strategy = mod(art, "util.scheduling_strategies") \
            .NodeAffinitySchedulingStrategy(node_id=target)
        value = art.get(consume.options(
            scheduling_strategy=strategy).remote(blob_ref))
        assert value == 400_000

        def runs_of(spans):
            return [s for s in spans if s["name"].startswith("run:")
                    and "consume" in s["name"]]

        def landed(spans):
            # Every span asserted on below: the worker's run span and
            # the daemon's pull span, in the run's trace.
            runs = runs_of(spans)
            return runs and any(
                s["name"] == "daemon:object_pull"
                and s["trace_id"] == runs[-1]["trace_id"] for s in spans)

        spans = _gcs_spans(art, landed)
        runs = runs_of(spans)
        assert runs, [s["name"] for s in spans]
        ours = [s for s in spans if s["trace_id"] == runs[-1]["trace_id"]]
        names = {s["name"] for s in ours}
        assert "daemon:object_pull" in names, names
        pull = next(s for s in ours if s["name"] == "daemon:object_pull")
        # The pull ran on the second node, stitched into the trace.
        assert pull["node_id"] == target[:12]
        assert runs[-1]["node_id"] == target[:12]
        return value, sorted(names - {runs[-1]["name"]}), \
            runs[-1]["name"].split(".")[-1]
    finally:
        art.shutdown()
        cluster.shutdown()


def test_two_node_cross_node_trace():
    """A traced task pinned to a second node pulls a head-owned plasma
    object: the execution span and the pull span land on node 2 under
    the driver's single trace id."""
    outs = []
    for art in PACKAGES:
        with _SampleAll(art):
            outs.append(_two_node_trace(art))
    assert outs[1] == outs[0]
    assert outs[1][0] == 400_000


def _post_json(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get_json(url, timeout=15):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def serve_request_one_trace_across_processes(art, dashboard):
    """One Serve request — HTTP ingress, router, replica, a nested actor
    task, a plasma pull — is one trace across >= 3 processes, and one
    tree through GET /api/trace/{id}."""
    serve = mod(art, "serve")
    blob_ref = art.put(np.zeros(300_000, dtype=np.uint8))  # plasma-sized

    @art.remote
    def nested(n):
        return int(n) * 2

    @serve.deployment(name="traced_dep", route_prefix="/traced_dep")
    class Traced:
        def __init__(self, cfg):
            self._ref = cfg["ref"]     # kept as a ref (nested in dict)

        def __call__(self, request):
            data = art.get(self._ref)                 # plasma pull
            return art.get(nested.remote(len(data)))  # nested task

    handle = serve.run(Traced.bind({"ref": blob_ref}), port=0)
    port = serve.api.run.last_http_port
    result = _post_json(f"http://127.0.0.1:{port}/traced_dep",
                        {})["result"]
    assert result == 600_000
    del handle

    def complete(spans):
        names = {s["name"] for s in spans}
        return (any(n.startswith("http:") for n in names)
                and "daemon:object_pull" in names
                and "replica:traced_dep" in names
                and any(n.startswith("run:") and "nested" in n
                        for n in names))

    spans = _gcs_spans(art, complete)
    http_spans = [s for s in spans if s["name"].startswith("http:")]
    assert http_spans, [s["name"] for s in spans]
    trace_id = http_spans[-1]["trace_id"]
    ours = [s for s in spans if s["trace_id"] == trace_id]
    names = {s["name"] for s in ours}
    assert {"route:traced_dep", "replica:traced_dep",
            "daemon:object_pull"} <= names, names
    assert any(n.startswith("run:") and "nested" in n for n in names)
    processes = len({(s.get("node_id"), s["pid"]) for s in ours})
    assert processes >= 3, ours
    body = _get_json(dashboard + f"/api/trace/{trace_id}")
    assert body["trace_id"] == trace_id
    assert body["span_count"] == len(ours)
    assert len(body["tree"]) == 1, [r["name"] for r in body["tree"]]
    root = body["tree"][0]
    assert root["name"].startswith("http:")

    def walk(node):
        yield node["name"]
        for c in node["children"]:
            yield from walk(c)

    flat = set(walk(root))
    assert {"replica:traced_dep", "daemon:object_pull"} <= flat
    return (result, root["name"], sorted(
        {"route:traced_dep", "replica:traced_dep", "daemon:object_pull"}
        & flat), processes >= 3)


def timeline_and_otlp_carry_request_spans(art, _dashboard):
    """Chrome-trace rows per request and the OTLP export read the same
    span ring."""
    trace = art.timeline()
    request_rows = [t for t in trace if t.get("cat") == "request_span"]
    assert request_rows
    assert any(t["name"].startswith("replica:") for t in request_rows)
    json.dumps(trace)                              # Perfetto-loadable
    tracing = mod(art, "util.tracing")
    spans = tracing.task_spans()
    live = [s for s in spans if s.name.startswith("replica:")]
    assert live, [s.name for s in spans][:20]
    otlp = tracing.export_otlp_json(spans=spans)[
        "resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert any(s["name"].startswith("replica:") for s in otlp)
    return sorted({t["name"] for t in request_rows
                   if t["name"].startswith("replica:")})


def flightrecorder_endpoint(art, dashboard):
    nodes = _get_json(dashboard + "/api/flightrecorder")
    assert nodes and all("spans" in n and "node_id" in n for n in nodes)
    # The daemon's own ring holds its lease and pull spans.
    names = {s["name"] for n in nodes for s in n["spans"]}
    assert names & {"daemon:lease", "daemon:object_pull"}, names
    return len(nodes), sorted(nodes[0])


def rpc_latency_histogram_with_exemplar(art, dashboard):
    req = urllib.request.Request(
        dashboard + "/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        content_type = resp.headers.get("Content-Type", "")
        text = resp.read().decode()
    assert "openmetrics" in content_type
    assert text.endswith("# EOF\n")
    lines = [line for line in text.splitlines()
             if line.startswith("art_rpc_latency_s_bucket")]
    assert lines, text[:2000]
    assert any('stage="execute"' in line or 'stage="wire"' in line
               for line in lines)
    # A bucket line carries an exemplar linking to a trace id.
    assert any("# {" in line and "trace_id=" in line for line in lines)
    # The classic text format: the same series, no exemplar suffixes.
    with urllib.request.urlopen(dashboard + "/metrics", timeout=15) as resp:
        plain = resp.read().decode()
    assert "art_rpc_latency_s_bucket" in plain
    assert not any("# {" in line for line in plain.splitlines())
    return content_type, text.endswith("# EOF\n")


def shed_and_deadline_spans_force_sampled(art, _dashboard):
    """429 (backpressure) and 504 (deadline) outcomes surface as error
    spans though the request was not head-sampled."""
    serve = mod(art, "serve")
    exc = mod(art, "exceptions")

    @serve.deployment(name="bounded_traced", max_ongoing_requests=1,
                      max_queued_requests=1)
    class Bounded:
        def __call__(self, request=None):
            time.sleep(0.5)
            return "ok"

    handle = serve.run(Bounded.bind())
    handle.call()                                  # warm
    cfg = mod(art, "_private.config").global_config()
    old = cfg.trace_sample_rate
    cfg.trace_sample_rate = 0.0                    # nothing head-sampled
    try:
        def hold():
            try:
                handle.call()
            except Exception:  # noqa: BLE001 — only the sheds are read
                pass

        # 1 running + 1 queued: the third call sheds (429-shaped).
        holders = [threading.Thread(target=hold) for _ in range(2)]
        for t in holders:
            t.start()
            time.sleep(0.1)
        with pytest.raises(exc.BackPressureError):
            handle.call()
        for t in holders:
            t.join()
        # A deadline expiring while queued: a 504-shaped shed.
        t = threading.Thread(target=hold)
        t.start()
        time.sleep(0.1)
        with pytest.raises(exc.DeadlineExceededError):
            handle.call(timeout_s=0.15)
        t.join()
    finally:
        cfg.trace_sample_rate = old

    def has_sheds(spans):
        kinds = {(s.get("attrs") or {}).get("shed") for s in spans}
        return {"BackPressureError", "DeadlineExceededError"} <= kinds

    spans = _gcs_spans(art, has_sheds, errors_only=True)
    shed = [s for s in spans
            if (s.get("attrs") or {}).get("shed") == "BackPressureError"]
    deadline = [s for s in spans if (s.get("attrs") or {}).get("shed")
                == "DeadlineExceededError"]
    assert shed and deadline, [
        (s["name"], s.get("attrs")) for s in spans][-20:]
    # Force-sampled: the sheds above ran at sample rate 0.
    assert any(s.get("forced") for s in shed + deadline)
    return bool(shed), bool(deadline), True


def serve_metric_series_expire_on_teardown(art, _dashboard):
    """MetricsExpire drops matching series; Serve's teardown uses it for
    deployment and replica gauges."""
    gcs = runtime(art)._gcs
    gcs.call("MetricRecord", {
        "name": "art_serve_queue_depth", "type": "gauge", "value": 3.0,
        "tags": {"deployment": "expire_me"}, "description": "t"})
    gcs.call("MetricRecord", {
        "name": "art_serve_breaker_state", "type": "gauge", "value": 0.0,
        "tags": {"deployment": "expire_me", "replica": "abc123"},
        "description": "t"})
    gcs.call("MetricRecord", {
        "name": "art_device_hbm_bytes_in_use", "type": "gauge",
        "value": 1.0, "tags": {"node_id": "deadbeef0000",
                               "device": "d0"}, "description": "t"})
    assert any(m["name"] == "art_serve_queue_depth"
               for m in gcs.call("MetricsGet"))
    dropped = gcs.call("MetricsExpire", {
        "match_tags": {"deployment": "expire_me"},
        "name_prefix": "art_serve_"})
    remaining = [m for m in gcs.call("MetricsGet")
                 if m["tags"].get("deployment") == "expire_me"]
    by_node = gcs.call("MetricsExpire", {
        "match_tags": {"node_id": "deadbeef0000"}})
    assert (dropped, remaining, by_node) == (2, [], 1)
    return dropped, remaining, by_node


TRACED_SCENARIOS = (serve_request_one_trace_across_processes,
                    timeline_and_otlp_carry_request_spans,
                    flightrecorder_endpoint,
                    rpc_latency_histogram_with_exemplar,
                    shed_and_deadline_spans_force_sampled,
                    serve_metric_series_expire_on_teardown)


@pytest.fixture(scope="module")
def traced():
    """{package id: {scenario: outcome}}: every traced scenario, in the
    reference's order, in each package's traced cluster in turn."""
    outs = {}
    for name, art in zip(IDS, PACKAGES):
        with _SampleAll(art):
            ctx = art.init(num_cpus=4,
                           _system_config={"include_dashboard": True})
            try:
                assert ctx.dashboard_url, f"{name}: no dashboard"
                outs[name] = {fn.__name__: outcome(
                    lambda fn=fn: fn(art, ctx.dashboard_url))
                    for fn in TRACED_SCENARIOS}
            finally:
                mod(art, "serve").shutdown()
                art.shutdown()
    return outs


def _equal(traced, scenario):
    want, got = (traced[name][scenario.__name__] for name in IDS)
    assert want[0] == "ok", want
    assert got == want
    return got[1]


def test_serve_request_one_trace_across_processes(traced):
    got = _equal(traced, serve_request_one_trace_across_processes)
    assert got[0] == 600_000 and got[3]


def test_timeline_and_otlp_carry_request_spans(traced):
    assert _equal(traced, timeline_and_otlp_carry_request_spans)


def test_flightrecorder_endpoint(traced):
    assert _equal(traced, flightrecorder_endpoint)[0] >= 1


def test_rpc_latency_histogram_with_exemplar(traced):
    assert _equal(traced, rpc_latency_histogram_with_exemplar)[1]


def test_shed_and_deadline_spans_force_sampled(traced):
    assert _equal(traced, shed_and_deadline_spans_force_sampled) == \
        (True, True, True)


def test_serve_metric_series_expire_on_teardown(traced):
    assert _equal(traced, serve_metric_series_expire_on_teardown) == \
        (2, [], 1)
