"""Dashboard head process: REST state API, Prometheus /metrics exporter,
and the job-submission server.

Capability mirror of the reference's dashboard head + job manager
(ref: python/ray/dashboard/head.py:49, dashboard/modules/job/
job_manager.py:62, _private/metrics_agent.py Prometheus export), as one
aiohttp process colocated with the head node.  Endpoints:

    GET  /api/nodes | /api/actors | /api/placement_groups | /api/objects
    GET  /api/tasks | /api/tasks/summary | /api/memory
    GET  /api/cluster_status | /api/export_events | /api/ha
    GET  /api/scale                       per-subsystem head cost counters
    GET  /api/timeline | /api/cpuprofile | /api/trace/{id}
    GET  /api/flightrecorder | /api/logs | /api/logs/{filename}
    GET  /metrics                         (Prometheus text format)
    POST /api/profile                     {node_id?, duration_s} → trace
    POST /api/jobs                        {entrypoint, runtime_env, ...}
    GET  /api/jobs            /api/jobs/{id}   /api/jobs/{id}/logs
    POST /api/jobs/{id}/stop

Jobs are driver subprocesses launched with ART_ADDRESS pointing at this
cluster (the reference's job supervisor pattern without the wrapper
actor — the dashboard process owns supervision).  A job driver inherits
the dashboard's environment, which is its launcher's: on a host with
cards it sees them, so the port's entry points run on CUDA there.

The JAX package's dashboard also serves flow insight (``/api/insight``),
ROADMAP queue A item 6.6: that route answers 501 with an error naming it.
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import threading
import time
import uuid

from ant_ray_tpu_torch._private.protocol import ClientPool


class JobManager:
    """Tracks driver subprocesses (ref: job_manager.py:62)."""

    def __init__(self, gcs_address: str, session_dir: str):
        self._gcs_address = gcs_address
        self._session_dir = session_dir
        self._jobs: dict[str, dict] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        # aiohttp dispatches handlers onto executor threads — every
        # _jobs/_procs mutation must hold this.
        self._lock = threading.Lock()

    def submit(self, entrypoint: str, runtime_env: dict | None = None,
               submission_id: str | None = None,
               metadata: dict | None = None) -> str:
        from ant_ray_tpu_torch._private.runtime_env import (  # noqa: PLC0415
            ensure_framework_on_pythonpath)

        job_id = submission_id or f"art-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            # reserve the id before the (slow) spawn so a concurrent
            # duplicate submit can't double-launch
            self._jobs[job_id] = self._record(job_id, entrypoint,
                                              "PENDING",
                                              metadata=metadata)
        log_path = os.path.join(self._session_dir, "logs",
                                f"job-{job_id}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        # Job drivers are user code that may run on the card: they take
        # this process's environment as it is (services.py stashes no
        # accelerator trigger from the control plane).
        env = dict(os.environ)
        env["ART_ADDRESS"] = self._gcs_address
        # Drivers must be able to import the framework even when it is
        # run from a checkout rather than pip-installed.
        ensure_framework_on_pythonpath(env)
        renv = runtime_env or {}
        env.update({str(k): str(v)
                    for k, v in (renv.get("env_vars") or {}).items()})
        cwd = renv.get("working_dir") or None
        log_file = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, env=env, cwd=cwd,
                stdout=log_file, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            log_file.close()
            with self._lock:
                self._jobs[job_id].update(status="FAILED",
                                          message=str(e))
            return job_id
        log_file.close()
        with self._lock:
            self._procs[job_id] = proc
            self._jobs[job_id].update(status="RUNNING")
        return job_id

    @staticmethod
    def _record(job_id, entrypoint, status, message="", metadata=None):
        return {"submission_id": job_id, "entrypoint": entrypoint,
                "status": status, "message": message,
                "metadata": metadata or {},
                "start_time": time.time(), "end_time": None}

    def _refresh_locked(self, job_id: str):
        job = self._jobs.get(job_id)
        proc = self._procs.get(job_id)
        if job is None or proc is None or job["status"] not in (
                "RUNNING", "STOPPING"):
            return
        code = proc.poll()
        if code is None:
            return
        job["end_time"] = time.time()
        if job["status"] == "STOPPING":
            job["status"] = "STOPPED"
        elif code == 0:
            job["status"] = "SUCCEEDED"
        else:
            job["status"] = "FAILED"
            job["message"] = f"driver exited with code {code}"

    def get(self, job_id: str) -> dict | None:
        with self._lock:
            self._refresh_locked(job_id)
            job = self._jobs.get(job_id)
            return dict(job) if job else None

    def list(self) -> list[dict]:
        with self._lock:
            for jid in list(self._jobs):
                self._refresh_locked(jid)
            return [dict(j) for j in self._jobs.values()]

    def stop(self, job_id: str) -> bool:
        with self._lock:
            job = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if job is None or proc is None or proc.poll() is not None:
                return False
            job["status"] = "STOPPING"
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        return True

    def logs(self, job_id: str) -> str:
        path = os.path.join(self._session_dir, "logs",
                            f"job-{job_id}.log")
        try:
            with open(path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def shutdown(self):
        with self._lock:
            procs = list(self._procs.values())
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    proc.terminate()


def _escape_label(value) -> str:
    """Prometheus exposition escaping: backslash, quote, newline."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _prometheus_text(series: list[dict], exemplars: bool = False) -> str:
    """Render the GCS metrics table in Prometheus exposition format.

    ``exemplars=True`` renders OpenMetrics exemplar suffixes on
    histogram bucket lines — legal ONLY in the OpenMetrics exposition
    format (the /metrics handler enables it when the scraper's Accept
    header negotiates ``application/openmetrics-text``; classic
    text-format parsers would fail the whole scrape on the `#`)."""
    lines = []
    seen_headers = set()
    for s in series:
        name = s["name"].replace("-", "_").replace(".", "_")
        if name not in seen_headers:
            seen_headers.add(name)
            if s.get("description"):
                help_text = (str(s["description"])
                             .replace("\\", r"\\").replace("\n", r"\n"))
                lines.append(f"# HELP {name} {help_text}")
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}.get(s["type"], "untyped")
            lines.append(f"# TYPE {name} {ptype}")
        pairs = [f'{k}="{_escape_label(v)}"'
                 for k, v in sorted(s.get("tags", {}).items())]
        label = f"{{{','.join(pairs)}}}" if pairs else ""
        if s["type"] == "histogram":
            # Cumulative buckets + the mandatory +Inf bucket (== count).
            # The latest exemplar (OpenMetrics: `# {trace_id="..."} v ts`)
            # is attached to the first bucket its value fits — a slow
            # histogram links straight to a concrete trace id.
            exemplar = s.get("exemplar") if exemplars else None
            ex_text = ""
            if exemplar:
                ex_pairs = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(
                        (exemplar.get("labels") or {}).items()))
                ex_text = (f" # {{{ex_pairs}}} {exemplar.get('value', 0)}"
                           f" {exemplar.get('ts', 0)}")
            cum = 0
            for le, n in zip(s.get("boundaries", ()),
                             s.get("buckets", ())):
                cum += n
                le_pairs = pairs + [f'le="{format(float(le), "g")}"']
                attach = ""
                if ex_text and exemplar.get("value", 0) <= float(le):
                    attach, ex_text = ex_text, ""
                lines.append(
                    f"{name}_bucket{{{','.join(le_pairs)}}} {cum}{attach}")
            inf_pairs = pairs + ['le="+Inf"']
            lines.append(
                f"{name}_bucket{{{','.join(inf_pairs)}}} "
                f"{s['count']}{ex_text}")
            lines.append(f"{name}_count{label} {s['count']}")
            lines.append(f"{name}_sum{label} {s['sum']}")
        else:
            lines.append(f"{name}{label} {s['value']}")
    return "\n".join(lines) + "\n"


def create_app(gcs_address: str, session_dir: str):
    from aiohttp import web

    clients = ClientPool()
    gcs = clients.get(gcs_address)
    jobs = JobManager(gcs_address, session_dir)

    def _nodes():
        infos = gcs.call("GetAllNodes", retries=3)
        return [{
            "node_id": i.node_id.hex(), "address": i.address,
            "alive": i.alive, "total_resources": i.total_resources,
            "available_resources": i.available_resources,
            "labels": i.labels,
        } for i in infos.values()]

    async def _call(fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    async def nodes(_req):
        return web.json_response(await _call(_nodes))

    async def actors(_req):
        return web.json_response(
            await _call(lambda: gcs.call("ListActors", retries=3)))

    async def pgs(_req):
        return web.json_response(
            await _call(lambda: gcs.call("ListPlacementGroups",
                                         retries=3)))

    async def objects(_req):
        # Directory joined with per-daemon residency (size / pins /
        # tier / chunk-cache) — the same join `art memory` renders, so
        # the UI and the CLI show one truth.
        def build():
            from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
                list_objects_joined,
            )

            return list_objects_joined(gcs, clients)
        return web.json_response(await _call(build))

    async def tasks(req):
        """Server-side-filtered task state from the bounded GCS table
        (?state=&name=&job_id=&actor_id=&node_id=&limit=&token=)."""
        query = req.query

        def build():
            token = query.get("token")
            return gcs.call("ListTasks", {
                "state": query.get("state"),
                "name": query.get("name"),
                "job_id": query.get("job_id"),
                "actor_id": query.get("actor_id"),
                "node_id": query.get("node_id"),
                "limit": int(query.get("limit", 1000)),
                "token": int(token) if token else None,
            }, retries=3)
        return web.json_response(await _call(build))

    async def tasks_summary(req):
        job_id = req.query.get("job_id")

        def build():
            return gcs.call("SummarizeTasks", {"job_id": job_id},
                            retries=3)
        return web.json_response(await _call(build))

    async def memory(req):
        top_n = int(req.query.get("top", 20))

        def build():
            from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
                build_memory_report,
            )

            return build_memory_report(gcs, clients, top_n=top_n)
        return web.json_response(await _call(build))

    def _ha_view():
        try:
            return gcs.call("GetHaView", {}, timeout=5, retries=1)
        except Exception:  # noqa: BLE001 — pre-HA head
            return None

    async def cluster_status(_req):
        def build():
            infos = gcs.call("GetAllNodes", retries=3)
            total = gcs.call("ClusterResources", retries=3)
            avail = gcs.call("AvailableResources", retries=3)
            return {"nodes_alive": sum(i.alive for i in infos.values()),
                    "nodes_dead": sum(not i.alive
                                      for i in infos.values()),
                    "resources_total": total,
                    "resources_available": avail,
                    "ha": _ha_view()}
        return web.json_response(await _call(build))

    async def ha(_req):
        """Control-plane HA view: leader identity, standby set with
        per-follower replication lag, last failover timestamp."""
        return web.json_response(await _call(_ha_view))

    async def scale(_req):
        """Scale observatory: the head's per-subsystem cost counters
        (GetScaleStats — per-method handle time, scheduler scan width,
        heartbeat ingest, table/ring occupancy, io-loop duty), with
        the handle counters pre-ranked for direct rendering."""
        def build():
            stats = gcs.call("GetScaleStats", retries=3)
            stats["handle_ranked"] = [
                {"method": m, "calls": c,
                 "total_ms": round(ns / 1e6, 2),
                 "us_per_call": round(ns / c / 1e3, 2) if c else None}
                for m, (c, ns) in sorted(
                    stats.get("handle", {}).items(),
                    key=lambda kv: -kv[1][1])]
            return stats
        return web.json_response(await _call(build))

    def unported(what: str):
        async def handler(_req):
            return web.json_response(
                {"error": f"{what} is not ported (ROADMAP queue A item "
                          "6.6)"}, status=501)
        return handler

    async def export_events(req):
        def build():
            return gcs.call("ExportEventsGet", {
                "source_type": req.query.get("source_type"),
                "limit": int(req.query.get("limit", 1000)),
            }, retries=3)
        return web.json_response(await _call(build))

    async def node_logs(req):
        node_id = req.query.get("node_id")

        def build():
            infos = gcs.call("GetAllNodes", retries=3)
            out = []
            for info in infos.values():
                if not info.alive:
                    continue
                if node_id and not info.node_id.hex().startswith(node_id):
                    continue
                files = clients.get(info.address).call(
                    "ListLogs", {}, retries=3)
                out.append({"node_id": info.node_id.hex(),
                            "files": files})
            return out
        return web.json_response(await _call(build))

    async def node_log_read(req):
        filename = req.match_info["filename"]
        node_id = req.query.get("node_id")
        tail = req.query.get("tail")

        def build():
            infos = gcs.call("GetAllNodes", retries=3)
            last_error = f"no alive node matches {node_id!r}"
            for info in infos.values():
                if not info.alive:
                    continue
                if node_id and not info.node_id.hex().startswith(node_id):
                    continue
                reply = clients.get(info.address).call(
                    "ReadLog",
                    {"filename": filename,
                     "tail": int(tail) if tail else None}, retries=3)
                if "error" in reply:
                    # The file lives on exactly one node — keep trying
                    # the other matches before reporting failure.
                    last_error = reply["error"]
                    continue
                return {"node_id": info.node_id.hex(),
                        "data": reply["data"].decode(
                            "utf-8", errors="replace"),
                        "eof": reply["eof"]}
            return {"error": last_error}
        return web.json_response(await _call(build))

    async def timeline(_req):
        def build():
            from ant_ray_tpu_torch.util.timeline import build_chrome_trace  # noqa: PLC0415

            events = gcs.call("TaskEventsGet", {"limit": 50000},
                              retries=3) or []
            steps = gcs.call("StepEventsGet", {"limit": 20000},
                             retries=3) or []
            try:
                spans = gcs.call("SpanEventsGet", {"limit": 50000},
                                 retries=3) or []
            except Exception:  # noqa: BLE001 — pre-upgrade GCS
                spans = []
            try:
                profiles = gcs.call("CpuProfileGet", {"limit": 4000},
                                    retries=3) or []
            except Exception:  # noqa: BLE001 — pre-upgrade GCS
                profiles = []
            return build_chrome_trace(events, step_events=steps,
                                      span_events=spans,
                                      cpu_profile=profiles)
        return web.json_response(await _call(build))

    async def cpuprofile(req):
        """Merged collapsed-stack capture of the whole cluster (or one
        node with ``?node_id=<prefix>``): the CLI `profile` data behind
        an HTTP GET.  ``?since_ts=`` narrows the window."""
        def build():
            from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

            payload: dict = {}
            if req.query.get("node_id"):
                payload["node_id"] = req.query["node_id"]
            if req.query.get("proc"):
                payload["proc"] = req.query["proc"]
            if req.query.get("since_ts"):
                payload["since_ts"] = float(req.query["since_ts"])
            records = gcs.call("CpuProfileGet", payload, retries=3) or []
            merged = cpu_profiler.merge_folded(records)
            return {"records": len(records),
                    "procs": sorted({r.get("proc", "?")
                                     for r in records}),
                    "samples": sum(int(r.get("samples") or 0)
                                   for r in records),
                    "stacks": merged,
                    "collapsed": cpu_profiler.render_folded(merged)}
        return web.json_response(await _call(build))

    async def trace(req):
        """One request's span tree: every hop (ingress → router →
        replica → nested tasks → pulls → lease grants) that published
        under this trace id, folded into a parent/child forest."""
        trace_id = req.match_info["trace_id"]

        def build():
            from ant_ray_tpu_torch.observability.tracing_plane import span_tree  # noqa: PLC0415

            spans = gcs.call("SpanEventsGet", {"trace_id": trace_id},
                             retries=3) or []
            return {"trace_id": trace_id, "span_count": len(spans),
                    "spans": spans, "tree": span_tree(spans)}
        return web.json_response(await _call(build))

    async def flightrecorder(req):
        """Live per-node flight-recorder rings (always on): the node
        daemon's in-memory spans — including force-sampled error spans
        — even when batch publication lags or the GCS ring wrapped.
        ``?node_id=<prefix>`` narrows to one node."""
        node_id = req.query.get("node_id")
        limit = int(req.query.get("limit", 0) or 0)

        def build():
            infos = gcs.call("GetAllNodes", retries=3)
            out = []
            for info in infos.values():
                if not info.alive:
                    continue
                if node_id and not info.node_id.hex().startswith(node_id):
                    continue
                try:
                    reply = clients.get(info.address).call(
                        "GetFlightRecorder", {"limit": limit},
                        timeout=5)
                except Exception:  # noqa: BLE001 — node mid-death
                    continue
                out.append(reply)
            return out
        return web.json_response(await _call(build))

    async def profile(req):
        """On-demand trace capture: route the request to the target
        node's agent, which runs ``torch.profiler`` into the
        session dir and archives it into the log dir (so the existing
        /api/logs routes list and serve it)."""
        try:
            body = await req.json()
        except Exception:  # noqa: BLE001 — empty body = defaults
            body = {}
        node_id = body.get("node_id")
        try:
            duration = float(body.get("duration_s", 2.0))
        except (TypeError, ValueError):
            return web.json_response({"error": "duration_s must be a "
                                               "number"}, status=400)

        def build():
            infos = gcs.call("GetAllNodes", retries=3)
            last_error = f"no alive node matches {node_id!r}"
            for info in infos.values():
                if not info.alive:
                    continue
                if node_id and not info.node_id.hex().startswith(node_id):
                    continue
                agent = clients.get(info.address).call(
                    "GetAgentInfo", {}, timeout=5) or {}
                addr = agent.get("address")
                if not addr or not agent.get("alive"):
                    # With no node pinned, keep looking: another node's
                    # agent may be alive even if this one is down.
                    last_error = ("node has no live agent (start the "
                                  "cluster with ART_ENABLE_NODE_AGENT=1)")
                    if node_id:
                        return {"error": last_error,
                                "node_id": info.node_id.hex()}
                    continue
                reply = dict(clients.get(addr).call(
                    "AgentProfile", {"duration_s": duration},
                    timeout=duration + 90) or {})
                reply["node_id"] = info.node_id.hex()
                return reply
            return {"error": last_error}
        return web.json_response(await _call(build))

    async def index(_req):
        from ant_ray_tpu_torch._private.dashboard_ui import INDEX_HTML  # noqa: PLC0415

        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def metrics(req):
        # Content negotiation: OpenMetrics scrapers (Accept names
        # application/openmetrics-text) get exemplar suffixes and the
        # mandatory EOF marker; classic text-format scrapers get plain
        # 0.0.4 lines (exemplars would fail their whole scrape).
        openmetrics = "application/openmetrics-text" in \
            req.headers.get("Accept", "")

        def build():
            series = gcs.call("MetricsGet", retries=3)
            infos = gcs.call("GetAllNodes", retries=3)
            avail = gcs.call("AvailableResources", retries=3)
            total = gcs.call("ClusterResources", retries=3)
            builtin = [
                {"name": "art_cluster_nodes_alive", "type": "gauge",
                 "tags": {}, "value": sum(
                     i.alive for i in infos.values()),
                 "description": "alive nodes"},
            ]
            # Per-node series, gathered from each daemon (role of the
            # reference's per-node metrics agents,
            # dashboard/agent.py:24 + _private/metrics_agent.py —
            # redesigned: the node daemon exports its own gauges over
            # RPC and the head scrapes, so there is no extra agent
            # process per node).  Scrapes run in PARALLEL: a hung
            # daemon costs one timeout, not one per node, keeping
            # /metrics inside Prometheus's scrape window.
            import concurrent.futures  # noqa: PLC0415

            def scrape(info):
                node_series = clients.get(info.address).call(
                    "GetNodeMetrics", {}, timeout=5)
                short = info.node_id.hex()[:12]
                for entry in node_series:
                    entry.setdefault("tags", {})["node_id"] = short
                return node_series

            alive = [i for i in infos.values() if i.alive]
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(16, max(1, len(alive)))) as pool:
                for fut in [pool.submit(scrape, i) for i in alive]:
                    try:
                        builtin.extend(fut.result())
                    except Exception:  # noqa: BLE001 — node mid-death
                        continue
            # The text format requires one contiguous group per metric
            # family; per-node appends interleave families, so sort
            # (stable: per-node order within a family is kept).
            builtin.sort(key=lambda e: e["name"])
            for res, tot in total.items():
                builtin.append({
                    "name": "art_cluster_resource_total", "type": "gauge",
                    "tags": {"resource": res}, "value": tot,
                    "description": "total cluster resources"})
                builtin.append({
                    "name": "art_cluster_resource_available",
                    "type": "gauge", "tags": {"resource": res},
                    "value": avail.get(res, 0.0),
                    "description": "available cluster resources"})
            text = _prometheus_text(builtin + series,
                                    exemplars=openmetrics)
            return text + "# EOF\n" if openmetrics else text
        return web.Response(
            text=await _call(build),
            content_type=("application/openmetrics-text" if openmetrics
                          else "text/plain"))

    async def submit_job(req):
        body = await req.json()
        if "entrypoint" not in body:
            return web.json_response({"error": "entrypoint required"},
                                     status=400)
        try:
            job_id = await _call(
                lambda: jobs.submit(
                    body["entrypoint"], body.get("runtime_env"),
                    body.get("submission_id"), body.get("metadata")))
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"submission_id": job_id})

    async def list_jobs(_req):
        return web.json_response(await _call(jobs.list))

    async def get_job(req):
        job = await _call(jobs.get, req.match_info["job_id"])
        if job is None:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response(job)

    async def job_logs(req):
        text = await _call(jobs.logs, req.match_info["job_id"])
        return web.json_response({"logs": text})

    async def stop_job(req):
        ok = await _call(jobs.stop, req.match_info["job_id"])
        return web.json_response({"stopped": bool(ok)})

    app = web.Application()
    app.router.add_get("/", index)
    app.router.add_get("/api/nodes", nodes)
    app.router.add_get("/api/actors", actors)
    app.router.add_get("/api/placement_groups", pgs)
    app.router.add_get("/api/objects", objects)
    app.router.add_get("/api/tasks", tasks)
    app.router.add_get("/api/tasks/summary", tasks_summary)
    app.router.add_get("/api/memory", memory)
    app.router.add_get("/api/cluster_status", cluster_status)
    app.router.add_get("/api/ha", ha)
    app.router.add_get("/api/scale", scale)
    app.router.add_get("/api/insight", unported("flow insight"))
    app.router.add_get("/api/export_events", export_events)
    app.router.add_get("/api/timeline", timeline)
    app.router.add_get("/api/cpuprofile", cpuprofile)
    app.router.add_get("/api/trace/{trace_id}", trace)
    app.router.add_get("/api/flightrecorder", flightrecorder)
    app.router.add_get("/api/logs", node_logs)
    app.router.add_get("/api/logs/{filename}", node_log_read)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/api/profile", profile)
    app.router.add_post("/api/jobs", submit_job)
    app.router.add_get("/api/jobs", list_jobs)
    app.router.add_get("/api/jobs/{job_id}", get_job)
    app.router.add_get("/api/jobs/{job_id}/logs", job_logs)
    app.router.add_post("/api/jobs/{job_id}/stop", stop_job)
    app["job_manager"] = jobs
    return app


def main():  # pragma: no cover — subprocess entry, driven by tests
    import argparse

    from aiohttp import web

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--monitor-pid", type=int, default=0)
    args = parser.parse_args()

    app = create_app(args.gcs_address, args.session_dir)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", args.port)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    print(f"DASH_READY http://127.0.0.1:{port}", flush=True)

    async def watch_parent():
        while True:
            await asyncio.sleep(1.0)
            if args.monitor_pid:
                try:
                    os.kill(args.monitor_pid, 0)
                except ProcessLookupError:
                    app["job_manager"].shutdown()
                    loop.stop()
                    return

    loop.create_task(watch_parent())
    try:
        loop.run_forever()
    except KeyboardInterrupt:
        pass
    app["job_manager"].shutdown()


if __name__ == "__main__":
    main()
