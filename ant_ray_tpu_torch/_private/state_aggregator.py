"""Cluster-state aggregation joins (ref: the reference's
``state_aggregator.py`` behind ``ray.util.state`` — the one place that
merges per-source truths into the operator view).

Two joins live here so every surface renders the SAME truth:

* :func:`list_objects_joined` — the GCS object directory (locations +
  owner attribution) joined with per-daemon arena stats (sizes, pins,
  storage tier, chunk-cache residency).  Feeds ``/api/objects``,
  ``art list objects``, and the memory report below.
* :func:`build_memory_report` — the ``ray memory`` analog: per-node
  usage, top-N objects by size with owner/holders/pin state (and the
  creation callsite when ``record_object_callsite`` was on), plus leak
  candidates (owner unreachable, or owner alive with no live
  reference).

Everything is duck-typed on ``gcs`` (an RpcClient for the head) and
``clients`` (a ClientPool) so the dashboard process, the operator CLI,
and a connected driver all share one implementation — none of them
needs a worker runtime.
"""

from __future__ import annotations


def _alive_nodes(gcs) -> dict[str, str]:
    """node_id hex -> daemon RPC address, alive nodes only."""
    infos = gcs.call("GetAllNodes", retries=3)
    return {info.node_id.hex(): info.address
            for info in infos.values() if info.alive}


def _daemon_object_stats(clients, nodes: dict[str, str],
                         timeout: float = 5.0) -> dict[str, dict]:
    """node_id hex -> ListObjectStats reply; nodes mid-death are
    skipped (their holdings vanish with them)."""
    out = {}
    for node_id, address in nodes.items():
        try:
            out[node_id] = clients.get(address).call(
                "ListObjectStats", {}, timeout=timeout)
        except Exception:  # noqa: BLE001 — node mid-death
            continue
    return out


def list_objects_joined(gcs, clients, per_node: dict | None = None
                        ) -> list[dict]:
    """Directory ∪ per-daemon residency, one record per object.
    ``per_node`` lets a caller that already swept the daemons (the
    memory report) reuse its snapshot instead of sweeping twice."""
    directory = gcs.call("ListObjects", retries=3) or []
    if per_node is None:
        per_node = _daemon_object_stats(clients, _alive_nodes(gcs))

    # object_id -> {node_id -> daemon-side stats}
    residency: dict[str, dict[str, dict]] = {}
    for node_id, reply in per_node.items():
        for entry in reply.get("objects", ()):
            residency.setdefault(entry["object_id"], {})[node_id] = entry

    out = []
    seen = set()
    for record in directory:
        oid = record["object_id"]
        seen.add(oid)
        copies = residency.get(oid, {})
        out.append(_joined_record(oid, record, copies))
    # Daemon-resident objects the directory doesn't (yet / anymore)
    # know — mid-registration or retraction lag; the bytes are real,
    # so the view includes them.
    for oid, copies in residency.items():
        if oid not in seen:
            out.append(_joined_record(oid, {}, copies))
    return out


def _joined_record(oid: str, directory_record: dict,
                   copies: dict[str, dict]) -> dict:
    size = max((c["size"] for c in copies.values()), default=None)
    return {
        "object_id": oid,
        "size": size,
        "owner": directory_record.get("owner"),
        "callsite": directory_record.get("callsite"),
        "locations": sorted(set(directory_record.get("locations") or ())
                            | set(copies)),
        "pinned": any(c.get("pins", 0) > 0 for c in copies.values()),
        "copies": [
            {"node_id": node_id, "size": c["size"],
             "pins": c.get("pins", 0), "tier": c.get("tier"),
             "chunk_cache_bytes": c.get("chunk_cache_bytes", 0)}
            for node_id, c in sorted(copies.items())
        ],
    }


def _owner_ref_info(clients, objects: list[dict],
                    timeout: float = 5.0) -> dict[str, dict | None | str]:
    """object_id -> owner-side refcounts, ``None`` (owner holds no
    reference state), or ``"owner_unreachable"``.  One RPC per OWNER,
    not per object."""
    by_owner: dict[str, list[str]] = {}
    for record in objects:
        if record.get("owner"):
            by_owner.setdefault(record["owner"], []).append(
                record["object_id"])
    out: dict[str, dict | None | str] = {}
    for owner, oids in by_owner.items():
        try:
            reply = clients.get(owner).call(
                "GetOwnedRefInfo", {"object_ids": oids},
                timeout=timeout)
        except Exception:  # noqa: BLE001 — owner process gone
            for oid in oids:
                out[oid] = "owner_unreachable"
            continue
        for oid in oids:
            out[oid] = reply.get(oid)
    return out


def build_memory_report(gcs, clients, top_n: int = 20) -> dict:
    """The ``ray memory`` analog (see module docstring)."""
    nodes = _alive_nodes(gcs)
    per_node = _daemon_object_stats(clients, nodes)
    objects = list_objects_joined(gcs, clients, per_node=per_node)
    ref_info = _owner_ref_info(clients, objects)

    for record in objects:
        info = ref_info.get(record["object_id"])
        if record.get("owner") is None:
            record["refs"] = None
            record["leak"] = None   # no attribution — can't judge
        elif info == "owner_unreachable":
            record["refs"] = None
            record["leak"] = "owner_dead"
        elif info is None and not record["pinned"]:
            # None is the owner's explicit "I hold NO reference state
            # for this id" (an all-zero count dict instead means the
            # owner still caches the value — alive, not a leak).  A
            # read-pinned copy has a live zero-copy reader even then.
            record["refs"] = None
            record["leak"] = "no_live_reference"
        else:
            record["refs"] = info
            record["leak"] = None

    objects.sort(key=lambda r: r["size"] or 0, reverse=True)
    node_rows = []
    for node_id, address in sorted(nodes.items()):
        reply = per_node.get(node_id)
        store = (reply or {}).get("store", {})
        node_rows.append({
            "node_id": node_id, "address": address,
            "used": store.get("used"),
            "capacity": store.get("capacity"),
            "spilled": store.get("spilled"),
            "objects": len((reply or {}).get("objects", ())),
        })
    return {
        "nodes": node_rows,
        "objects": objects[:max(0, int(top_n))],
        "leak_candidates": [r for r in objects if r.get("leak")],
        "totals": {
            "objects": len(objects),
            "bytes": sum(r["size"] or 0 for r in objects),
            "pinned_objects": sum(1 for r in objects if r["pinned"]),
            "chunk_cache_bytes": sum(
                c["chunk_cache_bytes"]
                for r in objects for c in r["copies"]),
        },
    }
