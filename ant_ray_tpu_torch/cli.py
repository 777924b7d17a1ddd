"""Operator CLI: ``python -m ant_ray_tpu_torch <subcommand>`` (ref: the
`ray list/summary/memory/status` CLI over ray.util.state).

Talks STRAIGHT to the cluster's RPC surfaces through a ClientPool — no
worker runtime, no driver registration: the CLI is a read-only
operator tool that must work against a wedged cluster that can't take
new drivers.  Every subcommand renders a human table by default and
the raw reply with ``--json`` (one JSON document on stdout — pipe to
jq).

    art() { python -m ant_ray_tpu_torch "$@"; }
    art status
    art list tasks --state RUNNING --limit 20
    art summary tasks
    art memory --top 10
    art list objects | nodes | actors | placement-groups | jobs
    art logs            # per-node log files;  art logs <file> --tail 100
    art trace <trace_id>

The cluster address comes from ``--address`` or the ``ART_ADDRESS``
environment variable (the same one job drivers use).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


# ------------------------------------------------------------ rendering

def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if value < 1024 or unit == "TiB":
            return (f"{value:.0f}{unit}" if unit == "B"
                    else f"{value:.1f}{unit}")
        value /= 1024
    return str(n)


def _fmt(value) -> str:
    if value is None:
        return "-"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return f"{value:.3f}"
    if isinstance(value, (list, tuple)):
        return ",".join(str(v) for v in value) or "-"
    if isinstance(value, dict):
        return json.dumps(value, sort_keys=True)
    return str(value)


def _table(rows: list[dict], columns: list[tuple[str, str]],
           out=sys.stdout) -> None:
    """Plain aligned columns: (key, HEADER) pairs; missing keys render
    as '-'.  No box-drawing — output must survive grep/awk."""
    headers = [header for _key, header in columns]
    cells = [[_fmt(row.get(key)) for key, _header in columns]
             for row in rows]
    widths = [max(len(headers[i]), *(len(r[i]) for r in cells))
              if cells else len(headers[i]) for i in range(len(columns))]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)),
          file=out)
    for row in cells:
        print("  ".join(c.ljust(w) for c, w in zip(row, widths)),
              file=out)
    if not rows:
        print("(none)", file=out)


def _short(value, n: int = 16):
    return value[:n] if isinstance(value, str) else value


# ------------------------------------------------------------ transport

class StateClient:
    """Thin RPC facade over the head + per-node daemons."""

    def __init__(self, address: str):
        from ant_ray_tpu_torch._private.protocol import ClientPool  # noqa: PLC0415

        self.address = address
        self.pool = ClientPool()
        self.gcs = self.pool.get(address)

    def call(self, method: str, payload: dict | None = None,
             timeout: float = 30.0):
        return self.gcs.call(method, payload or {}, timeout=timeout)

    def alive_nodes(self) -> dict[str, str]:
        from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
            _alive_nodes,
        )

        return _alive_nodes(self.gcs)


def _resolve_address(args) -> str:
    address = args.address or os.environ.get("ART_ADDRESS")
    if not address:
        print("error: no cluster address — pass --address host:port or "
              "set ART_ADDRESS", file=sys.stderr)
        raise SystemExit(2)
    return address


def _emit(args, payload, render) -> None:
    """--json prints the raw reply; otherwise the human renderer runs."""
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
    else:
        render(payload)


# ------------------------------------------------------------ commands

def cmd_status(client: StateClient, args) -> int:
    nodes = client.call("GetAllNodes")
    actors = client.call("ListActors")
    total = client.call("ClusterResources")
    avail = client.call("AvailableResources")
    try:
        tasks = client.call("SummarizeTasks")
    except Exception:  # noqa: BLE001 — pre-observatory head
        tasks = None
    try:
        ha = client.call("GetHaView")
    except Exception:  # noqa: BLE001 — pre-HA head
        ha = None
    stores = []
    for node_id, address in client.alive_nodes().items():
        try:
            store = client.pool.get(address).call("GetStoreStats", {},
                                                  timeout=5)
        except Exception:  # noqa: BLE001 — node mid-death
            continue
        stores.append({"node_id": node_id, **store})
    actor_states: dict[str, int] = {}
    for actor in actors:
        actor_states[actor["state"]] = \
            actor_states.get(actor["state"], 0) + 1
    payload = {
        "address": client.address,
        "ha": ha,
        "nodes": {"alive": sum(i.alive for i in nodes.values()),
                  "dead": sum(not i.alive for i in nodes.values()),
                  "draining": sum(
                      bool(getattr(i, "draining", False))
                      for i in nodes.values() if i.alive)},
        "resources_total": total,
        "resources_available": avail,
        "actors": actor_states,
        "tasks": (None if tasks is None else {
            "total": tasks["total_tasks"],
            "dropped": tasks["num_tasks_dropped"],
            "states": _merge_state_counts(tasks)}),
        "object_store": {
            "used": sum(s["used"] for s in stores),
            "capacity": sum(s["capacity"] for s in stores),
            "spilled": sum(s["spilled"] for s in stores)},
    }

    def render(p):
        n = p["nodes"]
        print(f"cluster   {p['address']}")
        view = p.get("ha")
        if view and view.get("ha"):
            print(f"control   leader {view.get('leader') or '?'} "
                  f"(term {view.get('term')})")
            standbys = [r for r in view.get("replicas", ())
                        if r.get("role") != "leader"]
            for r in standbys:
                lag = r.get("lag_s")
                print(f"  standby {r.get('address')} "
                      f"[{r.get('replica_id')}]"
                      + (f" lag {lag * 1000:.0f}ms"
                         if lag is not None else ""))
            failover = view.get("last_failover_ts")
            if failover:
                import datetime  # noqa: PLC0415

                stamp = datetime.datetime.fromtimestamp(failover)
                print(f"  last failover {stamp:%Y-%m-%d %H:%M:%S}")
        print(f"nodes     {n['alive']} alive / {n['dead']} dead"
              + (f" / {n['draining']} draining" if n["draining"]
                 else ""))
        for res, tot in sorted(p["resources_total"].items()):
            free = p["resources_available"].get(res, 0.0)
            print(f"  {res:<12} {tot - free:g}/{tot:g} used")
        if p["actors"]:
            print("actors    " + ", ".join(
                f"{k}={v}" for k, v in sorted(p["actors"].items())))
        if p["tasks"]:
            states = ", ".join(f"{k}={v}" for k, v in
                               sorted(p["tasks"]["states"].items()))
            print(f"tasks     {p['tasks']['total']} tracked"
                  + (f" ({states})" if states else "")
                  + (f", {p['tasks']['dropped']} dropped by GC"
                     if p["tasks"]["dropped"] else ""))
        store = p["object_store"]
        print(f"objects   {_fmt_bytes(store['used'])} / "
              f"{_fmt_bytes(store['capacity'])} in store"
              + (f", {_fmt_bytes(store['spilled'])} spilled"
                 if store["spilled"] else ""))

    _emit(args, payload, render)
    return 0


def _merge_state_counts(summary: dict) -> dict:
    out: dict[str, int] = {}
    for group in summary["summary"].values():
        for state, count in group["state_counts"].items():
            out[state] = out.get(state, 0) + count
    return out


def cmd_list(client: StateClient, args) -> int:
    kind = args.kind
    if kind == "tasks":
        reply = client.call("ListTasks", {
            "state": args.state, "name": args.name, "job_id": args.job,
            "actor_id": args.actor, "node_id": args.node,
            "limit": args.limit,
            "token": int(args.token) if args.token is not None
            else None})

        def render(p):
            for t in p["tasks"]:
                t["task"] = _short(t["task_id"])
                t["node"] = _short(t["node_id"] or "", 12)
            _table(p["tasks"], [("task", "TASK"), ("attempt", "ATT"),
                                ("name", "NAME"), ("state", "STATE"),
                                ("node", "NODE"), ("queue_s", "QUEUE_S"),
                                ("run_s", "RUN_S"), ("error", "ERROR")])
            if p.get("next_token") is not None:
                print(f"... more — continue with --token "
                      f"{p['next_token']}")
            if p.get("num_tasks_dropped"):
                print(f"({p['num_tasks_dropped']} records dropped by "
                      "table GC)")

        _emit(args, reply, render)
        return 0
    if kind == "actors":
        actors = client.call("ListActors")
        if args.state:
            actors = [a for a in actors if a["state"] == args.state]
        actors = actors[:args.limit]

        def render(rows):
            for a in rows:
                a["actor"] = _short(a["actor_id"])
                a["node"] = _short(a.get("node_id") or "", 12)
            _table(rows, [("actor", "ACTOR"), ("class_name", "CLASS"),
                          ("name", "NAME"), ("state", "STATE"),
                          ("node", "NODE"),
                          ("death_reason", "DEATH_REASON")])

        _emit(args, actors, render)
        return 0
    if kind == "objects":
        from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
            list_objects_joined,
        )

        objects = list_objects_joined(client.gcs, client.pool)
        if args.node:
            objects = [o for o in objects
                       if any(loc.startswith(args.node)
                              for loc in o["locations"])]
        objects.sort(key=lambda o: o["size"] or 0, reverse=True)
        objects = objects[:args.limit]

        def render(rows):
            for o in rows:
                o["object"] = _short(o["object_id"])
                o["bytes"] = _fmt_bytes(o["size"])
                o["nodes"] = [loc[:8] for loc in o["locations"]]
                o["tier"] = sorted({c["tier"] for c in o["copies"]
                                    if c.get("tier")}) or None
            _table(rows, [("object", "OBJECT"), ("bytes", "SIZE"),
                          ("nodes", "NODES"), ("tier", "TIER"),
                          ("pinned", "PINNED"), ("owner", "OWNER"),
                          ("callsite", "CALLSITE")])

        _emit(args, objects, render)
        return 0
    if kind == "nodes":
        # Server-side page + state filter (the ListTasks cursor idiom):
        # a 1000-node listing no longer ships the whole node table per
        # call, and `--state DEAD` filters at the source.
        reply = client.call("ListNodes", {
            "limit": args.limit, "token": args.token,
            "state": args.state})

        def render(p):
            for n in p["nodes"]:
                n["node"] = n["node_id"][:12]
                n["resources"] = n["total_resources"]
            _table(p["nodes"],
                   [("node", "NODE"), ("address", "ADDRESS"),
                    ("state", "STATE"), ("resources", "RESOURCES"),
                    ("labels", "LABELS")])
            if p.get("next_token"):
                print(f"... more — continue with --token "
                      f"{p['next_token']}")
            print(f"({len(p['nodes'])} shown, {p['matched']} matched, "
                  f"{p['total']} total)")

        _emit(args, reply, render)
        return 0
    if kind == "placement-groups":
        pgs = client.call("ListPlacementGroups")
        rows = [{"pg_id": pg_id, "pg": pg_id[:16], **record}
                for pg_id, record in pgs.items()]

        def render(r):
            _table(r, [("pg", "GROUP"), ("name", "NAME"),
                       ("state", "STATE"), ("strategy", "STRATEGY"),
                       ("bundles", "BUNDLES")])

        _emit(args, rows, render)
        return 0
    if kind == "jobs":
        jobs = client.call("ListJobs")

        def render(r):
            _table(r, [("job_id", "JOB"),
                       ("driver_address", "DRIVER"),
                       ("started_at", "STARTED_AT")])

        _emit(args, jobs, render)
        return 0
    print(f"error: unknown list kind {kind!r}", file=sys.stderr)
    return 2


def cmd_scale_report(args) -> int:
    """Control-plane cost curves: a sweep file given with ``--file``
    (the JSON the JAX package's benchmarks/scale_harness.py writes)
    plus — when a cluster is reachable — the live GetScaleStats
    attribution snapshot from the head.  No file is read unless one is
    given."""
    report = None
    if args.file and os.path.exists(args.file):
        with open(args.file) as f:
            report = json.load(f)
    live = None
    address = args.address or os.environ.get("ART_ADDRESS")
    if address:
        try:
            client = StateClient(address)
            try:
                live = client.call("GetScaleStats", timeout=10)
            finally:
                client.pool.close_all()
        except Exception as e:  # noqa: BLE001 — report works offline
            print(f"(no live cluster at {address}: {e})",
                  file=sys.stderr)
    if report is None and live is None:
        print(f"error: no sweep file at {args.file!r} and no "
              "reachable cluster — pass --file or --address",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"sweep": report, "live": live}, indent=2,
                         default=str))
        return 0
    if report is not None:
        print("== scale sweep "
              f"({report.get('generated_at', 'uncommitted')}, "
              f"{report['config'].get('cpu_count')} cpu) ==")
        rows = [{
            "nodes": r["nodes"],
            "leases_s": r.get("leases_per_s"),
            "hb_cpu_ms_100n": r.get("heartbeat_cpu_ms_per_s_per_100n"),
            "duty": r.get("gcs_io_loop_duty_loaded"),
            "scan_w": r.get("sched_scanned_nodes_per_pick"),
            "hit": r.get("pick_cache_hit_rate"),
            "failover_s": r.get("failover_s"),
        } for r in report.get("sweep", [])]
        _table(rows, [("nodes", "NODES"), ("leases_s", "LEASES/S"),
                      ("hb_cpu_ms_100n", "HB_CPU_MS/S/100N"),
                      ("duty", "IO_DUTY"), ("scan_w", "SCAN_WIDTH"),
                      ("hit", "CACHE_HIT"),
                      ("failover_s", "FAILOVER_S")])
        fix = report.get("cliff_fix") or {}
        if fix.get("nocache_sweep"):
            print(f"\n-- cliff fix: {fix.get('name')} "
                  f"({fix.get('flag')}=0 arm) --")
            _table([{"nodes": r["nodes"],
                     "leases_s": r.get("leases_per_s"),
                     "scan_w": r.get("sched_scanned_nodes_per_pick")}
                    for r in fix["nocache_sweep"]],
                   [("nodes", "NODES"), ("leases_s", "LEASES/S"),
                    ("scan_w", "SCAN_WIDTH")])
    if live is not None:
        print("\n== live head ==")
        print(f"table rows  {live['table_rows']}")
        print(f"rings       {live['rings']}")
        print(f"subscribers {live['subscribers']}   "
              f"io-loop duty {live.get('io_loop_duty')}")
        print(f"scheduler   {live['sched']}")
        print(f"heartbeat   {live['heartbeat']}")
        handle = sorted(live.get("handle", {}).items(),
                        key=lambda kv: -kv[1][1])[:args.top]
        rows = [{"method": m, "calls": c,
                 "total_ms": round(ns / 1e6, 2),
                 "us_per_call": round(ns / c / 1e3, 2) if c else None}
                for m, (c, ns) in handle]
        print(f"\n-- top {len(rows)} methods by server handle time --")
        _table(rows, [("method", "METHOD"), ("calls", "CALLS"),
                      ("total_ms", "TOTAL_MS"),
                      ("us_per_call", "US/CALL")])
    return 0


def cmd_summary(client: StateClient, args) -> int:
    reply = client.call("SummarizeTasks", {"job_id": args.job})

    def render(p):
        rows = []
        for name, group in sorted(p["summary"].items()):
            run = group.get("run_s") or {}
            rows.append({
                "name": name, "total": group["total"],
                "states": ", ".join(
                    f"{k}={v}" for k, v in
                    sorted(group["state_counts"].items())),
                "mean_s": run.get("mean"), "p50_s": run.get("p50"),
                "p99_s": run.get("p99")})
        _table(rows, [("name", "NAME"), ("total", "TOTAL"),
                      ("states", "STATES"), ("mean_s", "MEAN_S"),
                      ("p50_s", "P50_S"), ("p99_s", "P99_S")])
        if p.get("num_tasks_dropped"):
            print(f"({p['num_tasks_dropped']} records dropped by table "
                  "GC)")
        if p.get("task_events_dropped"):
            print(f"({p['task_events_dropped']} events dropped by "
                  "producer buffers)")

    _emit(args, reply, render)
    return 0


def cmd_memory(client: StateClient, args) -> int:
    from ant_ray_tpu_torch._private.state_aggregator import (  # noqa: PLC0415
        build_memory_report,
    )

    report = build_memory_report(client.gcs, client.pool,
                                 top_n=args.top)

    def render(p):
        print("per-node object store:")
        node_rows = [dict(n, node=n["node_id"][:12],
                          used_h=_fmt_bytes(n["used"]),
                          cap_h=_fmt_bytes(n["capacity"]),
                          spill_h=_fmt_bytes(n["spilled"]))
                     for n in p["nodes"]]
        _table(node_rows, [("node", "NODE"), ("used_h", "USED"),
                           ("cap_h", "CAPACITY"),
                           ("spill_h", "SPILLED"),
                           ("objects", "OBJECTS")])
        print(f"\ntop {len(p['objects'])} objects by size:")
        obj_rows = []
        for o in p["objects"]:
            refs = o.get("refs")
            obj_rows.append({
                "object": _short(o["object_id"]),
                "bytes": _fmt_bytes(o["size"]),
                "holders": [loc[:8] for loc in o["locations"]],
                "pinned": o["pinned"],
                "owner": o.get("owner"),
                "refs": ("-" if refs is None else
                         f"local={refs['local_refs']} "
                         f"borrows={refs['borrows']} "
                         f"pins={refs['pins']}"),
                "leak": o.get("leak"),
                "callsite": o.get("callsite")})
        _table(obj_rows, [("object", "OBJECT"), ("bytes", "SIZE"),
                          ("holders", "HOLDERS"), ("pinned", "PINNED"),
                          ("owner", "OWNER"), ("refs", "REFS"),
                          ("leak", "LEAK"), ("callsite", "CALLSITE")])
        t = p["totals"]
        print(f"\ntotal {t['objects']} objects, "
              f"{_fmt_bytes(t['bytes'])} "
              f"({t['pinned_objects']} pinned, "
              f"{_fmt_bytes(t['chunk_cache_bytes'])} chunk cache)")
        if p["leak_candidates"]:
            print(f"leak candidates: {len(p['leak_candidates'])} "
                  "(see LEAK column: owner_dead = owning worker "
                  "unreachable; no_live_reference = owner holds no "
                  "reference)")

    _emit(args, report, render)
    return 0


def cmd_logs(client: StateClient, args) -> int:
    nodes = client.alive_nodes()
    if args.node:
        nodes = {nid: addr for nid, addr in nodes.items()
                 if nid.startswith(args.node)}
        if not nodes:
            print(f"error: no alive node matches {args.node!r}",
                  file=sys.stderr)
            return 1
    if not args.filename:
        listing = []
        for node_id, address in sorted(nodes.items()):
            try:
                files = client.pool.get(address).call("ListLogs", {},
                                                      timeout=5)
            except Exception:  # noqa: BLE001 — node mid-death
                continue
            listing.append({"node_id": node_id, "files": files})

        def render(rows):
            for entry in rows:
                print(f"node {entry['node_id'][:12]}:")
                for f in entry["files"]:
                    print(f"  {_fmt_bytes(f['size']):>10}  "
                          f"{f['filename']}")

        _emit(args, listing, render)
        return 0
    last_error = "no nodes"
    for node_id, address in sorted(nodes.items()):
        try:
            reply = client.pool.get(address).call("ReadLog", {
                "filename": args.filename, "tail": args.tail,
                "max_bytes": args.max_bytes}, timeout=10)
        except Exception as e:  # noqa: BLE001 — node mid-death: try next
            last_error = f"{node_id[:12]}: {e}"
            continue
        if "error" in reply:
            last_error = reply["error"]
            continue
        text = reply["data"].decode("utf-8", errors="replace")
        if args.json:
            print(json.dumps({"node_id": node_id, "data": text,
                              "eof": reply.get("eof")}))
        else:
            sys.stdout.write(text)
        return 0
    print(f"error: {last_error}", file=sys.stderr)
    return 1


def cmd_profile(client: StateClient, args) -> int:
    """Whole-cluster CPU capture: wait out the window, then merge every
    process's published folded-stack deltas into ONE collapsed-stack
    document (flamegraph.pl / speedscope input).  ``--out`` writes the
    capture JSON that ``--diff`` consumes."""
    import time  # noqa: PLC0415

    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

    t0 = time.time()
    duration = max(float(args.duration), 0.0)
    if duration:
        time.sleep(duration)
    # Samplers publish on a period, not at capture edges: poll a short
    # grace window until the record set stops growing, so a capture
    # barely longer than one publish period still lands every process.
    records: list = []
    deadline = time.monotonic() + 6.0
    while True:
        payload: dict = {"since_ts": t0}
        if args.node:
            payload["node_id"] = args.node
        fresh = client.call("CpuProfileGet", payload) or []
        if len(fresh) > len(records):
            records = fresh
        elif records:
            break
        if time.monotonic() > deadline:
            break
        time.sleep(0.5)
    merged = cpu_profiler.merge_folded(records)
    capture = {
        "ts": t0, "duration_s": duration,
        "node_filter": args.node,
        "records": len(records),
        "procs": sorted({r.get("proc", "?") for r in records}),
        "samples": sum(int(r.get("samples") or 0) for r in records),
        "stacks": merged,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(capture, f)

    def render(p):
        print(cpu_profiler.render_folded(p["stacks"]))
        print(f"# {p['records']} records, {p['samples']} samples, "
              f"procs: {','.join(p['procs']) or '-'}",
              file=sys.stderr)

    _emit(args, capture, render)
    return 0


def cmd_profile_diff(args) -> int:
    """A/B two capture JSONs (from ``profile --out``): frames ranked by
    self-time delta, B minus A — regressions first."""
    from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

    with open(args.diff[0]) as f:
        a = json.load(f)
    with open(args.diff[1]) as f:
        b = json.load(f)
    rows = cpu_profiler.diff_folded(a.get("stacks") or {},
                                    b.get("stacks") or {})
    payload = {"a": args.diff[0], "b": args.diff[1],
               "frames": [{"frame": frame, "delta": delta,
                           "a": sa, "b": sb}
                          for frame, delta, sa, sb in rows]}

    def render(p):
        _table(p["frames"], [("frame", "FRAME"), ("delta", "DELTA"),
                             ("a", "A_SAMPLES"), ("b", "B_SAMPLES")])

    _emit(args, payload, render)
    return 0


def cmd_trace(client: StateClient, args) -> int:
    from ant_ray_tpu_torch.observability.tracing_plane import span_tree  # noqa: PLC0415

    spans = client.call("SpanEventsGet",
                        {"trace_id": args.trace_id}) or []
    payload = {"trace_id": args.trace_id, "span_count": len(spans),
               "tree": span_tree(spans)}

    def render(p):
        if not p["span_count"]:
            print(f"no spans for trace {args.trace_id} (sampled? "
                  "published yet?)")
            return

        def walk(node, depth):
            dur = node.get("dur_s")
            dur_text = f"{dur * 1000:.1f}ms" if dur is not None else "-"
            flags = " ERROR" if node.get("error") else ""
            print(f"{'  ' * depth}{node['name']}  {dur_text}  "
                  f"[{node.get('node_id', '')}:{node.get('pid', '')}]"
                  f"{flags}")
            for child in node.get("children", ()):
                walk(child, depth + 1)

        for root in p["tree"]:
            walk(root, 0)

    _emit(args, payload, render)
    return 0


# ------------------------------------------------------------- argparse

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m ant_ray_tpu_torch",
        description="cluster state observatory CLI")
    parser.add_argument("--address", default=None,
                        help="cluster head host:port (default: "
                             "$ART_ADDRESS)")
    parser.add_argument("--json", action="store_true",
                        help="print the raw reply as JSON")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("status", help="one-screen cluster overview")

    p_list = sub.add_parser("list", help="list cluster entities")
    p_list.add_argument("kind", choices=[
        "tasks", "actors", "objects", "nodes", "placement-groups",
        "jobs"])
    p_list.add_argument("--state", default=None,
                        help="filter by state (tasks/actors/nodes; "
                             "nodes: ALIVE|DEAD|DRAINING)")
    p_list.add_argument("--name", default=None,
                        help="filter tasks by function name")
    p_list.add_argument("--job", default=None,
                        help="filter tasks by job id (hex)")
    p_list.add_argument("--actor", default=None,
                        help="filter tasks by actor id (hex)")
    p_list.add_argument("--node", default=None,
                        help="filter by node id prefix")
    p_list.add_argument("--limit", type=int, default=100)
    p_list.add_argument("--token", default=None,
                        help="continuation token from the previous "
                             "page (tasks: int; nodes: node-id hex)")

    p_summary = sub.add_parser("summary", help="server-side rollups")
    p_summary.add_argument("kind", choices=["tasks"])
    p_summary.add_argument("--job", default=None)

    p_memory = sub.add_parser(
        "memory", help="object memory attribution (`ray memory` "
                       "analog)")
    p_memory.add_argument("--top", type=int, default=20,
                          help="how many objects by size")

    p_logs = sub.add_parser("logs", help="list / read node log files")
    p_logs.add_argument("filename", nargs="?", default=None)
    p_logs.add_argument("--node", default=None,
                        help="node id prefix")
    p_logs.add_argument("--tail", type=int, default=None)
    p_logs.add_argument("--max-bytes", type=int, default=65536)

    p_trace = sub.add_parser("trace",
                             help="render one request's span tree")
    p_trace.add_argument("trace_id")

    p_profile = sub.add_parser(
        "profile", help="whole-cluster collapsed-stack CPU capture "
                        "(flamegraph.pl / speedscope input)")
    p_profile.add_argument("--node", default=None,
                           help="node id prefix (default: every node)")
    p_profile.add_argument("--all", action="store_true",
                           help="whole cluster (the default; explicit "
                                "for scripts)")
    p_profile.add_argument("--duration", type=float, default=5.0,
                           help="capture window seconds")
    p_profile.add_argument("--out", default=None,
                           help="write the capture JSON here (the "
                                "--diff input format)")
    p_profile.add_argument("--diff", nargs=2,
                           metavar=("A.json", "B.json"), default=None,
                           help="rank frames by self-time delta "
                                "between two captures (no cluster "
                                "needed)")

    p_scale = sub.add_parser(
        "scale-report", help="control-plane cost curves (a sweep file "
                             "+ live GetScaleStats)")
    p_scale.add_argument("--file", default=None,
                         help="sweep JSON of a scale harness (none is "
                              "read unless given)")
    p_scale.add_argument("--top", type=int, default=12,
                         help="methods shown in the handle-time "
                              "ranking")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "profile" and args.diff:
        return cmd_profile_diff(args)  # purely local — no cluster
    if args.command == "scale-report":
        return cmd_scale_report(args)  # works offline from the file
    client = StateClient(_resolve_address(args))
    try:
        if args.command == "status":
            return cmd_status(client, args)
        if args.command == "list":
            return cmd_list(client, args)
        if args.command == "summary":
            return cmd_summary(client, args)
        if args.command == "memory":
            return cmd_memory(client, args)
        if args.command == "logs":
            return cmd_logs(client, args)
        if args.command == "trace":
            return cmd_trace(client, args)
        if args.command == "profile":
            return cmd_profile(client, args)
        return 2
    finally:
        client.pool.close_all()


if __name__ == "__main__":
    raise SystemExit(main())
