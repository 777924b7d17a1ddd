"""Flow insight: runtime call-graph / dataflow tracing (ant-fork
capability, ref: python/ray/util/insight.py:12-26 CallSubmitEvent /
CallBeginEvent / ObjectGet/Put events + dashboard/modules/insight/).

Workers and drivers emit lightweight events (oneway RPC, enabled by
``Config.enable_insight``) into a bounded GCS ring buffer; the
dashboard serves them at ``/api/insight`` and
:func:`build_call_graph` aggregates caller→callee edges with counts
and latency for visualization.
"""

from __future__ import annotations

import time


def _enabled_runtime():
    from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if not global_config().enable_insight:
        return None
    if not global_worker.connected:
        return None
    runtime = global_worker.runtime
    return runtime if hasattr(runtime, "_send_oneway") else None


def emit(event_type: str, **fields) -> None:
    """Record one flow event (best-effort oneway)."""
    runtime = _enabled_runtime()
    if runtime is None:
        return
    payload = {"type": event_type, "ts": time.time(),
               "source": runtime.address, **fields}
    runtime._send_oneway(runtime.gcs_address, "InsightRecord", payload)


def record_call_submit(function_name: str, task_id_hex: str,
                       caller: str) -> None:
    emit("call_submit", function=function_name, task_id=task_id_hex,
         caller=caller)


def record_call_begin(function_name: str, task_id_hex: str) -> None:
    emit("call_begin", function=function_name, task_id=task_id_hex)


def record_call_end(function_name: str, task_id_hex: str,
                    duration_s: float, error: bool = False) -> None:
    emit("call_end", function=function_name, task_id=task_id_hex,
         duration_s=duration_s, error=error)


def record_object_put(object_id_hex: str, size: int) -> None:
    emit("object_put", object_id=object_id_hex, size=size)


def record_object_get(object_id_hex: str) -> None:
    emit("object_get", object_id=object_id_hex)


def get_flow_events(limit: int = 1000) -> list[dict]:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker._check_connected()
    return global_worker.runtime._gcs.call(
        "InsightGet", {"limit": limit}, retries=3)


def build_call_graph(events: list[dict] | None = None) -> dict:
    """Aggregate events into {edges: {(caller, function): count},
    functions: {name: {calls, errors, total_s}}} for visualization."""
    if events is None:
        events = get_flow_events(limit=10000)
    edges: dict[tuple, int] = {}
    functions: dict[str, dict] = {}
    for ev in events:
        if ev["type"] == "call_submit":
            key = (ev.get("caller", "?"), ev["function"])
            edges[key] = edges.get(key, 0) + 1
        elif ev["type"] == "call_end":
            stats = functions.setdefault(
                ev["function"], {"calls": 0, "errors": 0, "total_s": 0.0})
            stats["calls"] += 1
            stats["errors"] += int(bool(ev.get("error")))
            stats["total_s"] += float(ev.get("duration_s", 0.0))
    return {
        "edges": [{"caller": c, "callee": f, "count": n}
                  for (c, f), n in sorted(edges.items())],
        "functions": functions,
    }
