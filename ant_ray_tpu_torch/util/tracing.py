"""Distributed tracing: task lifecycle events → OpenTelemetry spans (a
copy of ant_ray_tpu/util/tracing.py, which the port does not import;
ref: python/ray/util/tracing/tracing_helper.py — the reference wraps
task/actor calls in OTel spans when ``_tracing_startup_hook`` is set,
and proxy-mocks otel when it isn't installed, :147-176).

Two span sources, ONE code path out: requests traced by the live
tracing plane (observability/tracing_plane.py — contexts minted at
ingresses and PROPAGATED through request metadata, Dapper style)
surface their real cross-process spans via :func:`live_spans`; tasks no
propagated context covered (unsampled traffic) fall back to spans
DERIVED from the buffered task lifecycle events
(submitted/started/finished with parent linkage via contextvar), with
re-executed/retried attempts salted into distinct span ids.  The OTel
SDK stays optional:

* :func:`task_spans` — span objects (trace/span/parent ids, timings);
  propagated spans first, derived spans as the fallback
* :func:`export_otlp_json` — OTLP/JSON file any collector can ingest
* :func:`replay_to_otel` — emit through a real installed
  ``opentelemetry`` TracerProvider when the package is available (a
  ``tracer`` argument takes the place of the global provider's)

Imports no torch.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ant_ray_tpu_torch.util.timeline import fetch_task_events

_NS = 1_000_000_000


@dataclass
class Span:
    """One task execution, OTel-shaped."""

    trace_id: str            # 32 hex — the root task of the call tree
    span_id: str             # 16 hex — derived from the task id
    parent_span_id: str      # "" for roots
    name: str
    start_ns: int
    end_ns: int
    ok: bool = True
    attributes: dict = field(default_factory=dict)


def _span_id(task_id: str, attempt: int = 0) -> str:
    # Hash, don't truncate: task ids share a long job-id prefix, so a
    # prefix-slice would collide every span in a job.  The attempt
    # number salts the hash so a re-executed/retried task's span never
    # collides with the original run's (attempt 0 keeps the historical
    # unsalted id).
    import hashlib  # noqa: PLC0415

    key = task_id or ""
    if attempt:
        key = f"{key}#{attempt}"
    return hashlib.blake2b(key.encode(), digest_size=8).hexdigest()


def _trace_id(task_id: str) -> str:
    import hashlib  # noqa: PLC0415

    return hashlib.blake2b((task_id or "").encode(),
                           digest_size=16).hexdigest()


def live_spans(span_events: list[dict] | None = None) -> list[Span]:
    """Propagated request-trace spans (observability/tracing_plane.py:
    minted at ingresses, carried in request meta, published to the GCS
    span ring) as OTel-shaped :class:`Span` objects — real cross-process
    trace/span ids, not post-hoc derivations.  Stage timings surface as
    ``art.stage.<name>_s`` attributes."""
    if span_events is None:
        from ant_ray_tpu_torch.util.timeline import fetch_span_events  # noqa: PLC0415

        span_events = fetch_span_events()
    spans = []
    for s in span_events:
        attrs = dict(s.get("attrs") or {})
        for stage, sec in (s.get("stages") or {}).items():
            attrs[f"art.stage.{stage}_s"] = round(float(sec), 6)
        if s.get("node_id"):
            attrs["art.node_id"] = s["node_id"]
        if s.get("pid"):
            attrs["art.pid"] = s["pid"]
        if s.get("service"):
            attrs["art.service"] = s["service"]
        if s.get("error"):
            attrs["error"] = True
        ts = float(s.get("ts", 0.0))
        spans.append(Span(
            trace_id=s["trace_id"],
            span_id=s["span_id"],
            parent_span_id=s.get("parent_id") or "",
            name=s.get("name", "span"),
            start_ns=int(ts * _NS),
            end_ns=int((ts + float(s.get("dur_s", 0.0))) * _NS),
            ok=not s.get("error"),
            attributes=attrs,
        ))
    return spans


def task_spans(events: list[dict] | None = None,
               span_events: list[dict] | None = None) -> list[Span]:
    """ONE code path for spans: propagated request-trace spans where a
    context travelled (``live_spans``), with driver-local DERIVED spans
    as the fallback for tasks no propagated context covered (unsampled
    traffic, pre-upgrade workers).

    ``trace_id`` groups a call tree: a derived task inherits its root
    ancestor's id, so a driver-submitted task and everything it spawned
    share one trace (the W3C trace-context notion); propagated spans
    carry their minted ingress trace id as-is.  Re-executed/retried
    tasks derive one span per (task_id, attempt), attempt-salted ids."""
    explicit_events = events is not None
    if events is None:
        events = fetch_task_events()
    if span_events is None and not explicit_events:
        # Only reach for the cluster when the caller didn't hand us a
        # specific event set (unit-test / offline usage stays offline).
        from ant_ray_tpu_torch.util.timeline import fetch_span_events  # noqa: PLC0415

        try:
            span_events = fetch_span_events()
        except Exception:  # noqa: BLE001 — no cluster connected
            span_events = []
    live = live_spans(span_events or [])
    # Tasks already covered by a propagated execution span don't get a
    # second derived span (one instrumentation, not two vocabularies).
    covered = {s.attributes["task_id"] for s in live
               if "task_id" in s.attributes}
    by_task: dict[tuple, dict] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["task_id"] in covered:
            continue
        key = (e["task_id"], int(e.get("attempt") or 0))
        rec = by_task.setdefault(key, {"events": {}})
        rec["events"].setdefault(e["event"], e)

    # task_id -> any attempt's record, for parent-chain resolution (a
    # child's events name only the parent task, not its attempt).
    by_task_any: dict[str, dict] = {}
    for (tid, _attempt), rec in by_task.items():
        by_task_any.setdefault(tid, rec)

    def root_of(task_id: str, hops: int = 0) -> str:
        rec = by_task_any.get(task_id)
        if rec is None or hops > 256:
            return task_id
        for e in rec["events"].values():
            parent = e.get("parent_task_id")
            if parent:
                return root_of(parent, hops + 1)
        return task_id

    spans = list(live)
    for (task_id, attempt), rec in by_task.items():
        ev = rec["events"]
        started = ev.get("started")
        ended = ev.get("finished") or ev.get("failed")
        submitted = ev.get("submitted")
        if started is None:
            continue  # never ran (still queued, or events truncated)
        end_ts = (ended or started)["ts"]
        any_e = started
        parent = None
        for e in ev.values():
            parent = parent or e.get("parent_task_id")
        attributes = {
            "art.task_id": task_id,
            "art.node_id": any_e.get("node_id", ""),
            "art.pid": any_e.get("pid", 0),
        }
        if attempt:
            attributes["art.attempt"] = attempt
        if any_e.get("actor_id"):
            attributes["art.actor_id"] = any_e["actor_id"]
        if submitted is not None:
            attributes["art.queue_time_s"] = round(
                started["ts"] - submitted["ts"], 6)
        if "failed" in ev:
            # OTel semantic convention: failed spans carry error=true on
            # top of the ERROR status code the exporters set.
            attributes["error"] = True
        spans.append(Span(
            trace_id=_trace_id(root_of(task_id)),
            span_id=_span_id(task_id, attempt),
            parent_span_id=_span_id(parent) if parent else "",
            name=any_e.get("name", task_id),
            start_ns=int(started["ts"] * _NS),
            end_ns=int(end_ts * _NS),
            ok="failed" not in ev,
            attributes=attributes,
        ))
    spans.sort(key=lambda s: s.start_ns)
    return spans


def _otlp_attr(key: str, value) -> dict:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def export_otlp_json(filename: str | None = None,
                     spans: list[Span] | None = None):
    """OTLP/JSON ``resourceSpans`` payload (the shape OTLP/HTTP
    collectors and Jaeger's OTLP ingest accept); returns the dict, and
    writes it when ``filename`` is given."""
    if spans is None:
        spans = task_spans()
    payload = {"resourceSpans": [{
        "resource": {"attributes": [
            _otlp_attr("service.name", "ant_ray_tpu")]},
        "scopeSpans": [{
            "scope": {"name": "ant_ray_tpu.tasks"},
            "spans": [{
                "traceId": s.trace_id,
                "spanId": s.span_id,
                **({"parentSpanId": s.parent_span_id}
                   if s.parent_span_id else {}),
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(s.start_ns),
                "endTimeUnixNano": str(s.end_ns),
                "attributes": [_otlp_attr(k, v)
                               for k, v in s.attributes.items()],
                # STATUS_CODE_OK / STATUS_CODE_ERROR; per the OTLP spec
                # a message only accompanies ERROR.
                "status": ({"code": 2, "message": "task failed"}
                           if not s.ok else {"code": 1}),
            } for s in spans],
        }],
    }]}
    if filename:
        with open(filename, "w") as f:
            json.dump(payload, f)
        return filename
    return payload


def replay_to_otel(spans: list[Span] | None = None, tracer=None) -> int:
    """Emit spans through an installed ``opentelemetry`` SDK (optional
    dependency, like the reference's mock-when-absent behavior).

    The SDK generates its own trace/span ids, so linkage is preserved
    STRUCTURALLY: parents are emitted first and children start inside
    ``set_span_in_context(parent)`` — the backend sees the same tree
    ``task_spans`` computed, under SDK-assigned ids.  Returns the
    number of spans emitted."""
    try:
        from opentelemetry import trace as otel_trace  # noqa: PLC0415
    except ImportError as e:
        raise RuntimeError(
            "opentelemetry is not installed; use export_otlp_json() "
            "for a dependency-free OTLP payload") from e
    if spans is None:
        spans = task_spans()
    tracer = tracer or otel_trace.get_tracer("ant_ray_tpu.tasks")
    by_id = {s.span_id: s for s in spans}
    emitted: dict[str, object] = {}

    def emit(s: Span):
        if s.span_id in emitted:
            return emitted[s.span_id]
        context = None
        parent = by_id.get(s.parent_span_id)
        if parent is not None:
            context = otel_trace.set_span_in_context(emit(parent))
        span = tracer.start_span(s.name, context=context,
                                 start_time=s.start_ns,
                                 attributes=dict(s.attributes))
        if not s.ok:
            span.set_status(otel_trace.StatusCode.ERROR)
        emitted[s.span_id] = span
        return span

    for s in spans:
        emit(s)
    # End children before parents (reverse start order ≈ LIFO nesting).
    for s in sorted(spans, key=lambda s: s.start_ns, reverse=True):
        emitted[s.span_id].end(end_time=s.end_ns)
    return len(spans)
