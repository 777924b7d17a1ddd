"""Chrome-trace timeline export (a copy of ant_ray_tpu/util/timeline.py,
which the port does not import; ref capability: ``ray timeline`` —
python/ray/_private/state.py chrome_tracing_dump over GCS task events).

``timeline()`` pairs each task's started/finished events into complete
("ph": "X") slices — rows grouped by node (pid) and worker process
(tid) — plus flow arrows ("s"/"f") from submission to execution, so
chrome://tracing / Perfetto renders the cluster's task schedule with
cross-process causality.

Step-profiler records (observability/step_profiler.py) merge in as
per-rank "device" rows: one ``train-step/rank-N`` track per rank, each
step a slice subdivided into its phases (data_wait → h2d → compute →
collective, canonical order, measured durations) — so Perfetto shows
compute vs. transfer vs. collective right next to the task schedule.
Sampled request spans (observability/tracing_plane.py) merge in as one
``request/<trace8>`` track per trace, and CPU-profile publications, where
a GCS holds any, as ``cpu-profile`` rows.  Imports no torch.
"""

from __future__ import annotations

import json

# Canonical within-step phase order for the rendered sub-slices (phase
# seconds are attributions, not a measured schedule — see
# observability/step_profiler.py).
_STEP_PHASE_ORDER = ("data_wait", "h2d", "compute", "collective")


def fetch_task_events(limit: int = 50000) -> list[dict]:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    runtime = global_worker.runtime
    from ant_ray_tpu_torch._private import task_events  # noqa: PLC0415

    task_events.flush()  # this process's tail
    return runtime._gcs.call("TaskEventsGet", {"limit": limit},
                             retries=3) or []


def fetch_step_events(limit: int = 20000) -> list[dict]:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    runtime = global_worker.runtime
    try:
        return runtime._gcs.call("StepEventsGet", {"limit": limit},
                                 retries=3) or []
    except Exception:  # noqa: BLE001 — pre-upgrade GCS without the table
        return []


def fetch_span_events(limit: int = 50000,
                      trace_id: str | None = None) -> list[dict]:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    runtime = global_worker.runtime
    from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

    tracing_plane.flush()  # this process's pending tail
    payload: dict = {"limit": limit}
    if trace_id is not None:
        payload["trace_id"] = trace_id
    try:
        return runtime._gcs.call("SpanEventsGet", payload,
                                 retries=3) or []
    except Exception:  # noqa: BLE001 — pre-upgrade GCS without the ring
        return []


def fetch_cpu_profile(limit: int = 4000) -> list[dict]:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    runtime = global_worker.runtime
    try:
        return runtime._gcs.call("CpuProfileGet", {"limit": limit},
                                 retries=3) or []
    except Exception:  # noqa: BLE001 — pre-upgrade GCS without the ring
        return []


def build_cpu_profile_rows(profile_records: list[dict]) -> list[dict]:
    """Sampler-publication rows from the continuous CPU profiler
    (observability/cpu_profiler.py): one ``cpu-profile/<proc>-<pid>``
    track per publishing process, each publication window an "X" slice
    whose args carry the window's heaviest folded stacks — the
    wall-clock task schedule above, where the CPU actually went below."""
    trace: list[dict] = []
    pid = "cpu-profile"
    for rec in profile_records:
        dur = float(rec.get("dur_s", 0.0))
        if dur <= 0:
            continue
        ts_us = (float(rec.get("ts", 0.0)) - dur) * 1e6
        node8 = str(rec.get("node_id", ""))[:8]
        tid = f"{rec.get('proc', '?')}-{rec.get('pid', 0)}"
        stacks = rec.get("stacks") or {}
        top = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))[:5]
        args = {"node_id": node8, "samples": rec.get("samples"),
                "hz": rec.get("hz")}
        for rank, (stack, count) in enumerate(top, start=1):
            args[f"top{rank}"] = f"{count} {stack}"
        trace.append({
            "ph": "X", "cat": "cpu_profile",
            "name": f"samples={rec.get('samples', 0)}",
            "pid": pid, "tid": tid, "ts": ts_us, "dur": dur * 1e6,
            "args": args,
        })
    return trace


def build_request_rows(span_events: list[dict]) -> list[dict]:
    """Per-request rows from published trace spans
    (observability/tracing_plane.py): one ``request/<trace8>`` track per
    trace, each span an "X" slice (args carry stage seconds, node, pid,
    error) — Perfetto shows a serve request's ingress → router →
    replica → nested task → object-pull decomposition next to the task
    schedule."""
    trace: list[dict] = []
    pid = "request"
    for s in span_events:
        dur = float(s.get("dur_s", 0.0))
        ts_us = float(s.get("ts", 0.0)) * 1e6
        tid = str(s.get("trace_id", ""))[:8]
        args = {"trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "node_id": s.get("node_id"), "pid": s.get("pid")}
        for stage, sec in (s.get("stages") or {}).items():
            args[f"{stage}_s"] = round(float(sec), 6)
        args.update(s.get("attrs") or {})
        if s.get("error"):
            args["error"] = True
        trace.append({
            "ph": "X", "cat": "request_span",
            "name": s.get("name", "span"),
            "pid": pid, "tid": tid, "ts": ts_us, "dur": dur * 1e6,
            "args": args,
            **({"cname": "terrible"} if s.get("error") else {}),
        })
    return trace


def build_step_rows(step_events: list[dict]) -> list[dict]:
    """Per-rank device rows from published step records: one "X" slice
    per step ("step N", args carry phase seconds + MFU) and nested "X"
    sub-slices per phase in canonical order."""
    trace: list[dict] = []
    pid = "train-step"
    for rec in step_events:
        total = float(rec.get("total_s", 0.0))
        ts0_us = float(rec.get("ts", 0.0)) * 1e6
        if total <= 0:
            continue
        tid = f"rank-{int(rec.get('rank', 0))}"
        phases = {k: float(v)
                  for k, v in (rec.get("phases") or {}).items()}
        args = {f"{name}_s": round(sec, 6)
                for name, sec in sorted(phases.items())}
        if rec.get("mfu") is not None:
            args["mfu"] = rec["mfu"]
        trace.append({
            "ph": "X", "cat": "train_step",
            "name": f"step {int(rec.get('step', 0))}",
            "pid": pid, "tid": tid, "ts": ts0_us, "dur": total * 1e6,
            "args": args,
        })
        cursor = ts0_us
        end_us = ts0_us + total * 1e6
        ordered = [p for p in _STEP_PHASE_ORDER if p in phases]
        ordered += sorted(p for p in phases if p not in _STEP_PHASE_ORDER)
        for name in ordered:
            # Clamp into the parent slice: attributions can over-count
            # (an attached stream overlapping an explicit phase block)
            # and Perfetto rejects children escaping their parent.
            dur_us = min(phases[name] * 1e6, end_us - cursor)
            if dur_us <= 0:
                continue
            trace.append({
                "ph": "X", "cat": "step_phase", "name": name,
                "pid": pid, "tid": tid, "ts": cursor, "dur": dur_us,
            })
            cursor += dur_us
    return trace


def build_chrome_trace(events: list[dict],
                       step_events: list[dict] | None = None,
                       span_events: list[dict] | None = None,
                       cpu_profile: list[dict] | None = None
                       ) -> list[dict]:
    by_task: dict[str, dict] = {}
    for event in events:
        record = by_task.setdefault(event["task_id"], {"events": {}})
        record["events"][event["event"]] = event
    trace: list[dict] = []
    flow_id = 0
    for task_id, record in by_task.items():
        started = record["events"].get("started")
        done = (record["events"].get("finished")
                or record["events"].get("failed"))
        submitted = record["events"].get("submitted")
        if started is None:
            continue
        pid = started.get("node_id") or "node"
        tid = f"worker-{started.get('pid', 0)}"
        ts_us = started["ts"] * 1e6
        dur_us = ((done["ts"] - started["ts"]) * 1e6
                  if done is not None else 0.0)
        failed = "failed" in record["events"]
        trace.append({
            "ph": "X", "cat": "task",
            "name": started.get("name", task_id),
            "pid": pid, "tid": tid, "ts": ts_us, "dur": dur_us,
            "args": {"task_id": task_id,
                     # the parent is known at submission (the driver or
                     # the executing task that spawned this one)
                     "parent_task_id": (submitted or started).get(
                         "parent_task_id"),
                     "status": "failed" if failed else "ok"},
            **({"cname": "terrible"} if failed else {}),
        })
        if submitted is not None:
            flow_id += 1
            trace.append({
                "ph": "s", "cat": "submit", "id": flow_id,
                "name": "submit",
                "pid": submitted.get("node_id") or "driver",
                "tid": f"worker-{submitted.get('pid', 0)}",
                "ts": submitted["ts"] * 1e6})
            trace.append({
                "ph": "f", "cat": "submit", "id": flow_id,
                "name": "submit", "bp": "e",
                "pid": pid, "tid": tid, "ts": ts_us})
    if step_events:
        trace.extend(build_step_rows(step_events))
    if span_events:
        trace.extend(build_request_rows(span_events))
    if cpu_profile:
        trace.extend(build_cpu_profile_rows(cpu_profile))
    return trace


def timeline(filename: str | None = None) -> list[dict] | str:
    """Chrome trace of the cluster's task schedule — plus, when a step
    profiler published records, per-rank step-phase device rows, and
    when request traces were sampled, per-request span rows.  With
    ``filename`` writes the JSON and returns the path (load in
    chrome://tracing or https://ui.perfetto.dev); without, returns the
    event list."""
    trace = build_chrome_trace(fetch_task_events(),
                               step_events=fetch_step_events(),
                               span_events=fetch_span_events(),
                               cpu_profile=fetch_cpu_profile())
    if filename is None:
        return trace
    with open(filename, "w") as f:
        json.dump(trace, f)
    return filename
