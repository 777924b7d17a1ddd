"""Cluster state inspection API (ref: python/ray/util/state — list/get/
summarize entities served from GCS tables)."""

from __future__ import annotations

from dataclasses import dataclass


def _gcs():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker._check_connected()
    return global_worker.runtime._gcs


def _client_pool():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker._check_connected()
    return global_worker.runtime._clients


@dataclass
class NodeState:
    node_id: str
    address: str
    alive: bool
    total_resources: dict
    available_resources: dict
    labels: dict


@dataclass
class ActorState:
    actor_id: str
    class_name: str
    state: str
    address: str
    name: str
    death_reason: str
    job_id: str | None = None
    # Hosting node (drain-plane consumers map actors to DRAINING nodes).
    node_id: str | None = None


def list_nodes() -> list[NodeState]:
    nodes = _gcs().call("GetAllNodes", retries=3)
    return [
        NodeState(
            node_id=info.node_id.hex(),
            address=info.address,
            alive=info.alive,
            total_resources=info.total_resources,
            available_resources=info.available_resources,
            labels=info.labels,
        )
        for info in nodes.values()
    ]


def list_actors() -> list[ActorState]:
    records = _gcs().call("ListActors", retries=3)
    return [ActorState(**r) for r in records]


def list_placement_groups() -> dict:
    return _gcs().call("ListPlacementGroups", retries=3)


def list_objects(*, joined: bool = True) -> list[dict]:
    """Objects known to the cluster: the GCS directory joined with
    per-daemon residency (size, pins, storage tier, chunk-cache bytes)
    — the same join ``art memory`` and ``/api/objects`` render.
    ``joined=False`` returns the raw directory only."""
    if not joined:
        return _gcs().call("ListObjects", retries=3)
    from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
        list_objects_joined,
    )

    return list_objects_joined(_gcs(), _client_pool())


def memory_report(top_n: int = 20) -> dict:
    """Per-node object-store usage, top-N objects by size with
    owner/holders/pin attribution, and leak candidates (the ``ray
    memory`` analog; `art memory` renders this)."""
    from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
        build_memory_report,
    )

    return build_memory_report(_gcs(), _client_pool(), top_n=top_n)


def list_jobs() -> list[dict]:
    """Driver jobs registered with the GCS."""
    return _gcs().call("ListJobs", retries=3)


# State precedence for the thin-client fallback fold — events may
# arrive out of order (the driver's "submitted" batch can flush after
# the worker's "finished"), so a task's state only ever moves forward
# through this ranking, and terminal states are sticky (FINISHED and
# FAILED share a rank: a late duplicate flush must never flip one into
# the other).
_TASK_STATE_RANK = {"PENDING": 0, "PENDING_EXECUTION": 1, "RUNNING": 2,
                    "FINISHED": 3, "FAILED": 3}
_TERMINAL = ("FINISHED", "FAILED")


def _is_no_route(error: Exception) -> bool:
    return "no route for method" in str(error)


def list_tasks(limit: int = 1000, *, state: str | None = None,
               name: str | None = None, job_id: str | None = None,
               actor_id: str | None = None, node_id: str | None = None,
               token: int | None = None) -> list[dict]:
    """Per-(task, attempt) state records, filtered SERVER-SIDE from the
    bounded GCS state table (ref: the state API's ListTasks over
    GcsTaskManager's task table) — the raw event ring never crosses
    the wire.  Against a pre-observatory server, falls back to the thin
    client-side fold."""
    from ant_ray_tpu_torch._private.protocol import RpcError  # noqa: PLC0415

    try:
        reply = _gcs().call("ListTasks", {
            "state": state, "name": name, "job_id": job_id,
            "actor_id": actor_id, "node_id": node_id,
            "limit": limit, "token": token}, retries=3)
        return reply["tasks"]
    except RpcError as e:
        if not _is_no_route(e):
            raise
    return _list_tasks_fallback(limit, state=state, name=name,
                                job_id=job_id, actor_id=actor_id,
                                node_id=node_id)


def list_tasks_page(limit: int = 1000, token: int | None = None,
                    **filters) -> dict:
    """Paginated variant: the full ListTasks reply ({tasks,
    next_token, num_tasks_dropped, task_events_dropped})."""
    return _gcs().call("ListTasks",
                       {"limit": limit, "token": token, **filters},
                       retries=3)


def _list_tasks_fallback(limit: int, *, state=None, name=None,
                         job_id=None, actor_id=None,
                         node_id=None) -> list[dict]:
    """Client-side fold of the raw event ring, keyed by (task_id,
    attempt) with sticky terminal states — kept only for talking to
    old servers without the GCS state table."""
    events = _gcs().call("TaskEventsGet", {"limit": 50000},
                         retries=3) or []
    by_attempt: dict[tuple, dict] = {}
    for event in events:
        key = (event["task_id"], int(event.get("attempt") or 0))
        record = by_attempt.setdefault(key, {
            "task_id": event["task_id"], "attempt": key[1],
            "name": event["name"], "state": "PENDING", "node_id": "",
            "job_id": event.get("job_id"),
            "actor_id": event.get("actor_id")})
        new = {"submitted": "PENDING_EXECUTION",
               "started": "RUNNING",
               "finished": "FINISHED",
               "failed": "FAILED"}.get(event["event"])
        # Forward-only: strictly-higher rank moves the state, so an
        # equal-rank late "finished" can never overwrite FAILED, and a
        # terminal state never regresses to a retried-flush "started".
        if new is not None and _TASK_STATE_RANK[new] > \
                _TASK_STATE_RANK[record["state"]]:
            record["state"] = new
        if event["event"] == "started":
            record["node_id"] = event.get("node_id", "")
    out = [r for r in by_attempt.values()
           if (not state or r["state"] == state)
           and (not name or r["name"] == name)
           and (not job_id or r["job_id"] == job_id)
           and (not actor_id or r["actor_id"] == actor_id)
           and (not node_id or r["node_id"].startswith(node_id))]
    return out[-limit:]


def get_task(task_id: str) -> dict | None:
    """Every attempt of one task plus table stats (GetTask)."""
    return _gcs().call("GetTask", {"task_id": task_id}, retries=3)


def summarize_tasks(job_id: str | None = None) -> dict:
    """Group-by-name task rollup (per-state counts, run-duration
    mean/p50/p99) computed server-side (SummarizeTasks)."""
    return _gcs().call("SummarizeTasks", {"job_id": job_id}, retries=3)


def _matching_node_clients(node_id: str | None):
    """Yield (client, node_id_hex) for every alive node matching the id
    prefix — callers try each until one succeeds (a file lives on ONE
    node; with no node_id given, the right node is unknown a priori)."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    nodes = _gcs().call("GetAllNodes", retries=3)
    runtime = global_worker.runtime
    matched = False
    for info in nodes.values():
        if not info.alive:
            continue
        if node_id is None or info.node_id.hex().startswith(node_id):
            matched = True
            yield runtime._clients.get(info.address), info.node_id.hex()
    if not matched:
        raise ValueError(f"no alive node matches {node_id!r}")


def list_logs(node_id: str | None = None) -> dict:
    """Log files available on a node (default: the first alive node).
    (ref: ray.util.state.list_logs via the per-node log agent.)"""
    for client, nid in _matching_node_clients(node_id):
        return {"node_id": nid,
                "files": client.call("ListLogs", {}, retries=3)}
    raise ValueError(f"no alive node matches {node_id!r}")


def get_log(filename: str, node_id: str | None = None, *,
            tail: int | None = None, offset: int = 0,
            max_bytes: int = 65536) -> str:
    """Read a log file from a node without ssh (ref:
    ray.util.state.get_log).  Without a node_id every alive node is
    tried — the file lives on exactly one."""
    last_error = "no nodes"
    for client, _nid in _matching_node_clients(node_id):
        reply = client.call("ReadLog", {
            "filename": filename, "offset": offset, "tail": tail,
            "max_bytes": max_bytes}, retries=3)
        if "error" in reply:
            last_error = reply["error"]
            continue
        return reply["data"].decode("utf-8", errors="replace")
    raise FileNotFoundError(last_error)


def summarize_cluster() -> dict:
    nodes = list_nodes()
    actors = list_actors()
    return {
        "nodes": {"alive": sum(n.alive for n in nodes),
                  "dead": sum(not n.alive for n in nodes)},
        "actors": {
            state: sum(1 for a in actors if a.state == state)
            for state in {a.state for a in actors}
        },
        "resources_total": _gcs().call("ClusterResources", retries=3),
        "resources_available": _gcs().call("AvailableResources",
                                           retries=3),
    }
