"""The port's client half of the observability plane against the JAX
package's, on the same inputs made from a seeded numpy generator:
``util/timeline.py`` (Chrome trace with task, step, request-span and
CPU-profile rows), ``util/tracing.py`` (``live_spans``, ``task_spans``,
OTLP/JSON, the replay through an OpenTelemetry tracer), ``util/metrics.py``
payloads and the RPC histogram, ``device_stats_gauges``, step records and
their ``StepEventsAdd`` batches, the engine's ``llm:restore`` spans and
``LLMServer``'s span tree.  Tolerance: equal JSON (exemplar wall-clock
stamps excluded).  One test drives a traced actor call through a
cluster of the port (``init(num_cpus=2)``): timeline rows, one trace,
the RPC histogram with its exemplar, and the engine loop's gauges."""

import dataclasses
import importlib
import json
import time

import numpy as np
import pytest

import jax

from ant_ray_tpu.llm import LLMEngine as JaxEngine
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.llm.kv_offload import LocalKvStore as JaxStore
from ant_ray_tpu.llm.serve_llm import LLMServer as JaxServer
from ant_ray_tpu.models import llama as jl
from ant_ray_tpu.observability import device_stats as j_device_stats
from ant_ray_tpu.observability import step_profiler as j_step_profiler
from ant_ray_tpu.observability import tracing_plane as j_plane
from ant_ray_tpu.util import metrics as j_metrics
from ant_ray_tpu.util import timeline as j_timeline
from ant_ray_tpu.util import tracing as j_tracing
from ant_ray_tpu_torch.llm import LLMEngine, LLMServer, SamplingParams
from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.observability import device_stats as t_device_stats
from ant_ray_tpu_torch.observability import step_profiler as t_step_profiler
from ant_ray_tpu_torch.observability import tracing_plane as t_plane
from ant_ray_tpu_torch.util import metrics as t_metrics
from ant_ray_tpu_torch.util import timeline as t_timeline
from ant_ray_tpu_torch.util import tracing as t_tracing

DEADLINE_S = 120


def _hex(rng, digits):
    return "".join(f"{int(x):x}" for x in rng.integers(0, 16, digits))


def _recorded(seed=0, tasks=12, spans=10, steps=6, profiles=3):
    """Task events, span events, step records and CPU-profile records as
    a cluster's GCS holds them: parents, retried attempts, failures,
    actor tasks, tasks still queued, error and forced spans."""
    rng = np.random.default_rng(seed)
    events, ids = [], []
    t = 1000.0
    for i in range(tasks):
        tid = _hex(rng, 24)
        parent = ids[int(rng.integers(len(ids)))] if ids and i % 3 else None
        ids.append(tid)
        node, pid = _hex(rng, 12), int(rng.integers(100, 200))
        attempts = 2 if i % 5 == 4 else 1
        for attempt in range(attempts):
            common = {"task_id": tid, "name": f"f{i % 4}", "node_id": node,
                      "pid": pid, "attempt": attempt}
            if i % 4 == 1:
                common["actor_id"] = _hex(rng, 16)
            if parent:
                common["parent_task_id"] = parent
            t += float(rng.uniform(0.001, 0.01))
            events.append({**common, "event": "submitted", "ts": t})
            if i == tasks - 1:
                continue                              # still queued
            t += float(rng.uniform(0.001, 0.01))
            events.append({**common, "event": "started", "ts": t})
            t += float(rng.uniform(0.001, 0.05))
            end = "failed" if (i % 6 == 5 and attempt == attempts - 1) \
                else "finished"
            events.append({**common, "event": end, "ts": t})
    trace = _hex(rng, 32)
    span_events, span_ids = [], [""]
    for i in range(spans):
        sid = _hex(rng, 16)
        span = {"trace_id": trace, "span_id": sid,
                "parent_id": span_ids[int(rng.integers(len(span_ids)))],
                "name": ("call:f", "run:f", "llm:generate",
                         "llm:restore")[i % 4],
                "ts": 1000.0 + float(rng.uniform(0, 1)),
                "dur_s": float(rng.uniform(0.0001, 0.1)),
                "node_id": _hex(rng, 12), "pid": int(rng.integers(1, 99))}
        span_ids.append(sid)
        if i % 2:
            span["stages"] = {"queue": float(rng.uniform(0, 0.01)),
                              "execute": float(rng.uniform(0, 0.01))}
        if i % 3 == 0:
            span["attrs"] = {"task_id": ids[i], "session": "s",
                             "bytes": int(rng.integers(1, 1 << 20))}
        if i % 4 == 3:
            span["error"] = True
            span["forced"] = True
        if i % 5 == 0:
            span["service"] = "worker"
        span_events.append(span)
    step_events = [{"step": i, "ts": 1000.0 + i,
                    "total_s": float(rng.uniform(0.05, 0.2)) if i else 0.0,
                    "phases": {"data_wait": float(rng.uniform(0, 0.02)),
                               "h2d": float(rng.uniform(0, 0.02)),
                               "decode": float(rng.uniform(0, 0.3))},
                    "mfu": float(rng.uniform(0, 1)) if i % 2 else None,
                    "rank": i % 2} for i in range(steps)]
    cpu_profile = [{"ts": 1000.0 + i, "dur_s": float(rng.uniform(0, 2))
                    if i else 0.0, "node_id": _hex(rng, 16),
                    "proc": "worker", "pid": 7 + i, "samples": 10 * i,
                    "hz": 67.0, "stacks": {f"a;b{j}": int(rng.integers(1, 9))
                                           for j in range(7)}}
                   for i in range(profiles)]
    return events, span_events, step_events, cpu_profile


def _json(x):
    return json.dumps(x, sort_keys=True)


def _spans_json(spans):
    return _json([dataclasses.asdict(s) for s in spans])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_equals_the_reference(seed):
    events, spans, steps, cpu = _recorded(seed)
    kw = dict(step_events=steps, span_events=spans, cpu_profile=cpu)
    got = t_timeline.build_chrome_trace(events, **kw)
    want = j_timeline.build_chrome_trace(events, **kw)
    assert _json(got) == _json(want)
    cats = {e.get("cat") for e in got}
    assert {"task", "submit", "train_step", "step_phase", "request_span",
            "cpu_profile"} <= cats
    for builder in ("build_step_rows", "build_request_rows",
                    "build_cpu_profile_rows"):
        arg = {"build_step_rows": steps, "build_request_rows": spans,
               "build_cpu_profile_rows": cpu}[builder]
        assert _json(getattr(t_timeline, builder)(arg)) == \
            _json(getattr(j_timeline, builder)(arg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spans_and_otlp_equal_the_reference(seed):
    events, spans, _, _ = _recorded(seed)
    assert _spans_json(t_tracing.live_spans(spans)) == \
        _spans_json(j_tracing.live_spans(spans))
    for span_events in (spans, []):
        got = t_tracing.task_spans(events, span_events=span_events)
        want = j_tracing.task_spans(events, span_events=span_events)
        assert _spans_json(got) == _spans_json(want)
        assert _json(t_tracing.export_otlp_json(spans=got)) == \
            _json(j_tracing.export_otlp_json(spans=want))
    # Retried attempts get salted ids; a covered task is not re-derived.
    derived = t_tracing.task_spans(events, span_events=[])
    assert len({s.span_id for s in derived}) == len(derived)
    assert t_tracing._span_id("t", 1) == j_tracing._span_id("t", 1) != \
        t_tracing._span_id("t")


def test_otlp_file_equals_the_reference(tmp_path):
    events, spans, _, _ = _recorded(3)
    paths = []
    for pkg in (t_tracing, j_tracing):
        path = tmp_path / f"{pkg.__name__}.json"
        assert pkg.export_otlp_json(
            str(path), spans=pkg.task_spans(events, span_events=spans)) \
            == str(path)
        paths.append(path.read_text())
    assert json.loads(paths[0]) == json.loads(paths[1])


class _Tracer:
    """Records what ``replay_to_otel`` asks of an OpenTelemetry tracer."""

    def __init__(self):
        self.calls = []

    def start_span(self, name, context=None, start_time=None,
                   attributes=None):
        tracer = self

        class _S:
            def get_span_context(self):
                return None

            def set_status(self, status):
                tracer.calls.append(("status", name, str(status)))

            def end(self, end_time=None):
                tracer.calls.append(("end", name, end_time))

            def is_recording(self):
                return True

        parent = None
        if context is not None:
            parent = [c for c in tracer.calls if c[0] == "start"
                      and c[4] == id(next(iter(context.values())))]
            parent = parent[0][1] if parent else "?"
        span = _S()
        tracer.calls.append(("start", name, start_time,
                             tuple(sorted((attributes or {}).items())),
                             id(span), parent))
        return span


def _replay(pkg, spans):
    tracer = _Tracer()
    try:
        n = pkg.replay_to_otel(spans, tracer=tracer)
    except RuntimeError as e:        # no opentelemetry: both must say so
        return ("raise", "opentelemetry" in str(e))
    return n, [c[:4] + c[5:] for c in tracer.calls]


@pytest.mark.parametrize("seed", [0, 4])
def test_replay_to_otel_equals_the_reference(seed):
    events, spans, _, _ = _recorded(seed)
    got = _replay(t_tracing, t_tracing.task_spans(events, span_events=spans))
    want = _replay(j_tracing, j_tracing.task_spans(events,
                                                   span_events=spans))
    assert got == want


# -------------------------------------------------------------- metrics

def _capture(monkeypatch, module):
    sent = []
    monkeypatch.setattr(module, "_record", sent.append)
    return sent


def _no_ts(payloads):
    out = []
    for p in payloads:
        p = json.loads(json.dumps(p))
        if "exemplar" in p:
            assert p["exemplar"].pop("ts") > 0
        out.append(p)
    return out


def _observe(pkg, rng_seed):
    rng = np.random.default_rng(rng_seed)
    c = pkg.Counter("art_c", "a counter", tag_keys=("k",))
    c.set_default_tags({"k": "d", "z": "1"})
    g = pkg.Gauge("art_g", "a gauge")
    h = pkg.Histogram("art_h", "a histogram",
                      boundaries=[0.5, 0.01, 0.1], tag_keys=("m",))
    for i in range(6):
        v = float(rng.uniform(0, 1))
        c.inc(v, {"k": f"v{i % 2}"} if i % 3 else None)
        g.set(-v, {"g": str(i)})
        h.observe(v, {"m": "x"},
                  exemplar={"trace_id": _hex(rng, 32)} if i % 2 else None)
    c.inc()
    with pytest.raises(ValueError, match="counters only increase"):
        c.inc(-1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_payloads_equal_the_reference(monkeypatch, seed):
    got, want = (_capture(monkeypatch, t_metrics),
                 _capture(monkeypatch, j_metrics))
    _observe(t_metrics, seed)
    _observe(j_metrics, seed)
    assert len(got) == 19
    assert _no_ts(got) == _no_ts(want)


def test_metrics_outside_a_cluster_are_dropped():
    """No runtime (and local mode, which has no GCS): nothing is sent
    and nothing raises."""
    import ant_ray_tpu_torch as art

    t_metrics.Gauge("art_g").set(1.0)
    art.init(local_mode=True)
    try:
        t_metrics.Histogram("art_h", boundaries=[1.0]).observe(0.5)
        t_metrics.Counter("art_c").inc()
    finally:
        art.shutdown()


@pytest.mark.parametrize("daemon", [False, True])
def test_rpc_histogram_payloads_equal_the_reference(monkeypatch, daemon):
    """``record_rpc`` observes through ``Histogram`` in drivers and
    workers, and through the installed sender in the node daemon; both
    give the reference's payloads."""
    out = {}
    for plane, metrics in ((t_plane, t_metrics), (j_plane, j_metrics)):
        sent = _capture(monkeypatch, metrics)
        if daemon:
            monkeypatch.setattr(plane, "_metric_recorder", sent.append)
        plane.record_rpc("PushTask", {"queue": 0.0003, "execute": 7.0},
                         "ab" * 16)
        plane.record_rpc("LeaseWorker", {"wire": 0.02})
        out[plane] = _no_ts(sent)
    assert len(out[t_plane]) == 3
    assert out[t_plane] == out[j_plane]
    assert out[t_plane][0]["exemplar"]["labels"] == {"trace_id": "ab" * 16}


def test_device_stats_gauges_equal_the_reference():
    rng = np.random.default_rng(5)
    stats = [{"index": i, "device": f"cuda:{i}", "platform": "gpu",
              "bytes_in_use": int(rng.integers(1 << 30)),
              "peak_bytes_in_use": int(rng.integers(1 << 31)),
              "bytes_limit": 85_000_000_000} for i in range(2)]
    stats.append({"index": 2, "device": "cpu", "platform": "cpu",
                  "bytes_in_use": None, "peak_bytes_in_use": None,
                  "bytes_limit": None})
    stats.append({"index": 3, "platform": "gpu", "bytes_in_use": 5,
                  "peak_bytes_in_use": None, "bytes_limit": 9})
    got = t_device_stats.device_stats_gauges(stats)
    assert _json(got) == _json(j_device_stats.device_stats_gauges(stats))
    assert [s["name"] for s in got[:3]] == [
        "art_device_hbm_bytes_in_use", "art_device_hbm_peak_bytes",
        "art_device_hbm_bytes_limit"]
    # On this CPU the port's own statistics have no card: no series.
    assert t_device_stats.device_stats_gauges() == []


# --------------------------------------------------------- step records

def test_step_record_round_trips_as_the_reference():
    kw = dict(step=3, start_ts=123.0, total_s=0.5,
              phases={"compute": 0.4, "h2d": 0.1}, mfu=0.37, rank=2)
    rec = t_step_profiler.StepRecord(**kw)
    assert t_step_profiler.StepRecord.from_dict(rec.as_dict()) == rec
    assert rec.as_dict() == j_step_profiler.StepRecord(**kw).as_dict()


class _Clock:
    """A deterministic ``time`` for a profiler module."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._t = 50.0

    def perf_counter(self):
        self._t += float(self._rng.uniform(0.001, 0.01))
        return self._t

    def time(self):
        return 1.7e9 + self._t


class _Runtime:
    gcs_address = "gcs:1"

    def __init__(self):
        self._gcs = object()
        self.sent = []

    def _send_oneway(self, address, method, payload):
        self.sent.append((address, method, json.loads(json.dumps(payload))))


def _profile(monkeypatch, module, worker_module):
    runtime = _Runtime()
    monkeypatch.setattr(worker_module.global_worker, "runtime", runtime)
    monkeypatch.setattr(module, "time", _Clock(11))
    prof = module.StepProfiler(flops_per_step=1e9, peak_flops=1e12,
                               publish_batch=2)
    for i in range(5):
        with prof.step():
            with prof.phase("decode"):
                pass
            if i % 2:
                with prof.phase("prefill"):
                    pass
    sent_before_close = len(runtime.sent)
    prof.close()
    prof.flush()                                  # nothing pending: no-op
    return sent_before_close, runtime.sent


def test_step_events_batches_equal_the_reference(monkeypatch):
    t_worker = importlib.import_module("ant_ray_tpu_torch._private.worker")
    j_worker = importlib.import_module("ant_ray_tpu._private.worker")
    got = _profile(monkeypatch, t_step_profiler, t_worker)
    want = _profile(monkeypatch, j_step_profiler, j_worker)
    assert got == want
    assert got[0] == 2 and len(got[1]) == 3
    assert [m for _, m, _ in got[1]] == ["StepEventsAdd"] * 3
    assert [r["step"] for _, _, p in got[1] for r in p["records"]] == \
        list(range(5))


def test_step_events_outside_a_cluster_are_dropped():
    prof = t_step_profiler.StepProfiler(publish_batch=1)
    with prof.step():
        pass
    assert prof._pending == [] and len(prof.records) == 1
    quiet = t_step_profiler.StepProfiler(publish=False)
    with quiet.step():
        pass
    assert quiet._pending == []


# ------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jl.CONFIGS["tiny"], jax.random.PRNGKey(7))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                    tl.CONFIGS["tiny"], device="cpu")
    return jparams, tparams


def _engines(weights, store_cls):
    kw = dict(slots=2, max_seq=96, prefill_chunk_tokens=8)
    return [(LLMEngine("tiny", weights[1], device="cpu",
                       kv_offload_store=store_cls[0](), **kw),
             SamplingParams, t_plane),
            (JaxEngine(jl.CONFIGS["tiny"], weights[0],
                       kv_offload_store=store_cls[1](), **kw),
             JaxSampling, j_plane)]


def _drain(eng):
    outs = {}
    deadline = time.monotonic() + DEADLINE_S
    while eng.has_unfinished():
        for out in eng.step():
            outs[out.request_id] = out
        assert time.monotonic() < deadline, "engine never drained"
    return outs


def _trace_spans(plane, ctx):
    return [s for s in plane.recorder().snapshot()
            if s["trace_id"] == ctx.trace_id]


def _restore_turns(eng, sampling, plane, ctx):
    eng.add_request([5, 9, 17, 3, 88, 41, 2, 7, 1, 4], sampling(max_tokens=4),
                    admit=False, session_id="s")
    _drain(eng)
    assert eng.evict_session("s")
    eng.add_request([21, 22], sampling(max_tokens=4), admit=False,
                    session_id="s", trace_ctx=ctx)
    outs = list(_drain(eng).values())
    spans = _trace_spans(plane, ctx)
    return ([(s["name"], s["parent_id"], s["attrs"], bool(s.get("error")))
             for s in spans], [o.token_ids for o in outs],
            [o.error is None for o in outs],
            eng.stats["offload_bytes"])


def test_restore_span_equals_the_reference(weights):
    wire = ("c" * 32, "d" * 16, True)
    got, want = (_restore_turns(eng, sampling, plane,
                                plane.TraceContext.from_wire(wire))
                 for eng, sampling, plane in _engines(
                     weights, (LocalKvStore, JaxStore)))
    assert got == want
    spans, _, ok, offload_bytes = got
    assert ok == [True]
    assert spans == [("llm:restore", "d" * 16,
                      {"session": "s", "bytes": offload_bytes}, False)]


class _LostStore(LocalKvStore):
    def get(self, handle):
        raise RuntimeError("the slab is gone")


class _JaxLostStore(JaxStore):
    def get(self, handle):
        raise RuntimeError("the slab is gone")


@pytest.mark.parametrize("sampled", [True, False])
def test_failed_restore_span_equals_the_reference(weights, sampled):
    """The error span is force-sampled: an unsampled request's failed
    restore is recorded too."""
    wire = (("e" if sampled else "f") * 32, "a" * 16, sampled)
    got, want = (_restore_turns(eng, sampling, plane,
                                plane.TraceContext.from_wire(wire))
                 for eng, sampling, plane in _engines(
                     weights, (_LostStore, _JaxLostStore)))
    assert got == want
    spans, tokens, ok, _ = got
    assert ok == [False] and tokens == [[]]
    assert spans == [("llm:restore", "a" * 16,
                      {"session": "s",
                       "error": "RuntimeError('the slab is gone')"}, True)]


def test_unsampled_context_records_nothing(weights):
    wire = ("9" * 32, "8" * 16, False)
    for eng, sampling, plane in _engines(weights,
                                         (LocalKvStore, JaxStore)):
        spans, _, ok, _ = _restore_turns(
            eng, sampling, plane, plane.TraceContext.from_wire(wire))
        assert spans == [] and ok == [True]


# --------------------------------------------------------------- LLMServer

@pytest.fixture(scope="module")
def servers():
    kw = dict(slots=2, max_seq=96, kv_offload="local")
    jax_srv = JaxServer("tiny", **kw)
    srv = LLMServer("tiny", device="cpu", **kw)
    yield jax_srv, srv
    jax_srv.shutdown()
    srv.shutdown()


def _tree(plane, ctx):
    """The trace's spans as (name, parent's name, attributes, error),
    sorted: span ids are random, the shape is not."""
    spans = _trace_spans(plane, ctx)
    names = {s["span_id"]: s["name"] for s in spans}
    names[ctx.span_id] = "<root>"
    return sorted((s["name"], names.get(s["parent_id"], "<orphan>"),
                   _json(s.get("attrs")), bool(s.get("error")))
                  for s in spans)


REQUESTS = {
    "completion": {"prompt": [5, 9, 17, 3], "max_tokens": 3},
    "batch": {"prompt": ["ab", "cd"], "max_tokens": 2},
    "chat": {"messages": [{"role": "user", "content": "hi"}],
             "max_tokens": 2},
    "stream": {"prompt": [7, 8, 9], "max_tokens": 3},
    "chat_stream": {"messages": [{"role": "user", "content": "yo"}],
                    "max_tokens": 2},
}


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_server_span_tree_equals_the_reference(servers, kind):
    request = REQUESTS[kind]
    trees = []
    for srv, plane in zip(servers, (j_plane, t_plane)):
        ctx = plane.mint(sampled=True)
        with plane.use(ctx):
            if "stream" in kind:
                chunks = list(srv.stream(request))
                assert chunks[-1]["done"]
            else:
                assert srv(request)["choices"]
        trees.append(_tree(plane, ctx))
    assert trees[0] == trees[1]
    outer = "llm:stream" if "stream" in kind else "llm:generate"
    assert {(n, p) for n, p, _, _ in trees[1]} == {
        (outer, "<root>"), ("llm:admission", "<root>")}


def test_server_without_a_context_records_nothing(servers):
    srv = servers[1]
    before = len(t_plane.recorder().snapshot())
    srv(REQUESTS["completion"])
    list(srv.stream(REQUESTS["stream"]))
    assert len(t_plane.recorder().snapshot()) == before


# ------------------------------------------------------------ the cluster

def _poll(fn, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        value = fn()
        if value:
            return value
        assert time.monotonic() < deadline, f"never saw {what}"
        time.sleep(0.2)


def test_traced_actor_call_in_a_cluster():
    import ant_ray_tpu_torch as art
    from ant_ray_tpu_torch._private.worker import global_worker

    class Traced:
        """The actor: an ``LLMServer`` on ``tiny`` on the CPU, whose loop
        publishes its gauges every interval."""

        def __init__(self):
            from ant_ray_tpu_torch.llm import LLMServer as Server

            self.server = Server("tiny", device="cpu", slots=2, max_seq=96,
                                 kv_offload="local")

        def complete(self, request):
            return self.server(request)["choices"][0]["token_ids"]

    # Spans recorded by earlier tests of this process are still pending:
    # a flush without a runtime drops them, so none reaches this GCS.
    t_plane.flush()
    art.init(num_cpus=2)
    try:
        gcs = global_worker.runtime._gcs
        untraced = t_plane.mint(sampled=False)
        with t_plane.use(untraced):
            actor = art.remote(Traced).remote()
            want = art.get(actor.complete.remote(REQUESTS["completion"]),
                           timeout=DEADLINE_S)
        ctx = t_plane.mint(sampled=True)
        t_plane.record_span(ctx, "test:request", ts=time.time(), dur_s=0.0,
                            span_id=ctx.span_id, parent_id="")
        with t_plane.use(ctx):
            got = art.get(actor.complete.remote(REQUESTS["completion"]),
                          timeout=DEADLINE_S)
        assert got == want and len(got) == 3

        def spans():
            events = t_timeline.fetch_span_events()
            return events if {"run:Traced.complete", "llm:generate",
                              "llm:admission"} <= {
                s["name"] for s in events} else None

        events = _poll(spans, "the worker's spans")
        live = t_tracing.live_spans(events)
        assert {s.trace_id for s in live} == {ctx.trace_id}, [
            (s.name, s.attributes) for s in live if s.trace_id != ctx.trace_id]
        ids = {s.span_id for s in live}
        roots = [s for s in live if s.parent_span_id not in ids]
        assert [(s.name, s.parent_span_id) for s in roots] == [
            ("test:request", "")]
        by_id = {s.span_id: s for s in live}
        parent = {s.name: by_id[s.parent_span_id].name for s in live
                  if s.parent_span_id}
        assert parent["call:Traced.complete"] == "test:request"
        assert parent["run:Traced.complete"] == "call:Traced.complete"
        assert parent["llm:generate"] == parent["llm:admission"] == \
            "run:Traced.complete"
        covered = [s for s in t_tracing.task_spans()
                   if s.trace_id == ctx.trace_id]
        assert {s.name for s in covered} == {s.name for s in live}

        trace = art.timeline()
        tasks = {e["name"] for e in trace if e.get("ph") == "X"
                 and e.get("cat") == "task"}
        assert "Traced.complete" in tasks
        rows = [e for e in trace if e.get("cat") == "request_span"]
        assert {e["tid"] for e in rows} == {ctx.trace_id[:8]}
        assert {"llm:generate", "run:Traced.complete"} <= {
            e["name"] for e in rows}

        def series():
            found = {}
            for m in gcs.call("MetricsGet", {}, retries=3):
                if m["name"] == "art_rpc_latency_s" and \
                        m.get("exemplar", {}).get("labels", {}).get(
                            "trace_id") == ctx.trace_id:
                    found.setdefault("rpc", []).append(m)
                if m["name"].startswith("art_llm_") and \
                        m["tags"] == {"deployment": "llm"}:
                    found.setdefault("llm", set()).add(m["name"])
            return found if len(found.get("llm", ())) == 3 and \
                len(found.get("rpc", ())) >= 4 else None

        found = _poll(series, "the RPC histogram and the loop's gauges")
        stages = {m["tags"]["stage"] for m in found["rpc"]}
        assert {"client_queue", "client_wire", "queue", "execute"} <= stages
        for m in found["rpc"]:
            assert m["type"] == "histogram"
            assert sum(m["buckets"]) == m["count"] >= 1
    finally:
        art.shutdown()


def test_observability_exports_match_the_reference():
    import ant_ray_tpu.observability as j_obs
    import ant_ray_tpu_torch.observability as t_obs

    assert set(t_obs.__all__) == set(j_obs.__all__)
    assert t_obs.tracing_plane is t_plane
    assert t_obs.TraceContext is t_plane.TraceContext
    assert t_obs.FlightRecorder is t_plane.FlightRecorder
    assert t_obs.device_stats_gauges is t_device_stats.device_stats_gauges
