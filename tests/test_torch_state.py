"""The port's state API (``util/state.py``), its aggregation joins
(``_private/state_aggregator.py``) and the operator CLI (``python -m
ant_ray_tpu_torch``) against the JAX package's: the memory-report cases
of tests/test_state_observatory.py on equal fake inputs, and its
cluster scenarios (server-side task filters and pages, retried attempts,
the dashboard's state routes, object callsites, two-node memory
attribution, the CLI's ``--json`` replies) run through a cluster of each
package, whose outcomes — states, counts, key sets — must be equal.

Both clusters are started with the dashboard and object callsites on
through the ``ART_*`` variables both packages read (never two
``_system_config`` exports at once)."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (jart, tart)


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _wait_for(predicate, timeout=20.0, interval=0.3):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError("condition not met before timeout")


# ---------------------------------------------------------------------------
# the aggregator on fake inputs (tests/test_state_observatory.py's fakes)
# ---------------------------------------------------------------------------


class _FakeNodeId:
    def __init__(self, hexid):
        self._hex = hexid

    def hex(self):
        return self._hex


class _FakeNodeInfo:
    def __init__(self, hexid, address, alive=True):
        self.node_id = _FakeNodeId(hexid)
        self.address = address
        self.alive = alive


class _FakeClient:
    def __init__(self, replies):
        self.replies = replies

    def call(self, method, payload=None, **kw):
        reply = self.replies[method]
        if isinstance(reply, Exception):
            raise reply
        return reply(payload) if callable(reply) else reply


class _FakePool:
    def __init__(self, clients):
        self.clients = clients

    def get(self, address):
        return self.clients[address]


def _fake_cluster(owner_reply, seed=0):
    """One node holding objects of seeded sizes (the first is the
    reference's 1024-byte object with its callsite)."""
    rng = np.random.default_rng(seed)
    oids = ["aa" * 8] + [f"{i:016x}" for i in rng.integers(1, 1 << 40, 3)]
    sizes = [1024] + [int(s) for s in rng.integers(1, 1 << 20, 3)]
    gcs = _FakeClient({
        "GetAllNodes": {"n": _FakeNodeInfo("node1" * 4, "daemon:1")},
        "ListObjects": [
            {"object_id": oid, "locations": ["node1" * 4],
             "owner": "owner:1", "callsite": "app.py:7"}
            for oid in oids[:-1]],
    })
    daemon = _FakeClient({
        "ListObjectStats": {
            "node_id": "node1" * 4,
            "objects": [{"object_id": oid, "size": size,
                         "pins": int(i == 1), "sealed": True,
                         "tier": "arena", "created_age_s": 1.0,
                         "chunk_cache_bytes": 128}
                        for i, (oid, size) in enumerate(zip(oids, sizes))],
            "store": {"used": sum(sizes), "capacity": 1 << 24,
                      "spilled": 0},
        },
    })
    pool = _FakePool({"daemon:1": daemon, "owner:1": owner_reply})
    return gcs, pool


OWNER_REPLIES = {
    "owner_dead": ConnectionError("gone"),
    "no_live_reference": {"aa" * 8: None},
    "live_reference": {"aa" * 8: {"local_refs": 2, "borrows": 0,
                                  "pins": 0}},
    "owner_cached_zero_counts": {"aa" * 8: {"local_refs": 0,
                                            "borrows": 0, "pins": 0}},
}


@pytest.mark.parametrize("case", sorted(OWNER_REPLIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_memory_report_equals_the_reference(case, seed):
    reports = []
    for art in PACKAGES:
        agg = _mod(art, "_private.state_aggregator")
        gcs, pool = _fake_cluster(_FakeClient({
            "GetOwnedRefInfo": OWNER_REPLIES[case]}), seed)
        reports.append((agg.build_memory_report(gcs, pool, top_n=3),
                        agg.build_memory_report(gcs, pool, top_n=10),
                        agg.list_objects_joined(gcs, pool)))
    assert reports[0] == reports[1]
    report = reports[1][1]
    (obj,) = [o for o in report["objects"] if o["object_id"] == "aa" * 8]
    want_leak = {"owner_dead": "owner_dead",
                 "no_live_reference": "no_live_reference"}.get(case)
    assert obj["leak"] == want_leak
    assert obj["size"] == 1024 and obj["callsite"] == "app.py:7"
    assert len(reports[1][0]["objects"]) == 3 and len(report["objects"]) == 4
    assert report["totals"]["chunk_cache_bytes"] == 4 * 128


def test_memory_attribution_two_nodes():
    """A put object pulled to a second node: both holders report the
    copy, the driver owns it with a live reference, no leak.  (Before
    the module's clusters start: one cluster of a package at a time.)"""
    outcomes = []
    for art in PACKAGES:
        utils = _mod(art, "cluster_utils")
        state = _mod(art, "util.state")
        strategies = _mod(art, "util.scheduling_strategies")
        cluster = utils.Cluster(head_node_args={"num_cpus": 1})
        second = cluster.add_node(num_cpus=1)
        try:
            cluster.connect()
            target = next(n["NodeID"] for n in art.nodes()
                          if n["Address"] == second)
            blob_ref = art.put(np.ones(400_000, dtype=np.uint8))

            @art.remote
            def consume(arr):
                return int(arr.sum())

            strategy = strategies.NodeAffinitySchedulingStrategy(
                node_id=target)
            assert art.get(consume.options(
                scheduling_strategy=strategy).remote(blob_ref)) == 400_000

            def attributed():
                report = state.memory_report(top_n=10)
                ours = [o for o in report["objects"]
                        if o["object_id"] == blob_ref.id.hex()]
                if ours and len(ours[0]["locations"]) >= 2:
                    return report, ours[0]
                return None

            report, obj = _wait_for(attributed)
            outcomes.append({
                "nodes": len(report["nodes"]),
                "copies": {c["node_id"] for c in obj["copies"]}
                == set(obj["locations"]),
                "sizes": all(c["size"] == obj["size"]
                             for c in obj["copies"]),
                "owned": bool(obj["owner"]) and
                obj["refs"]["local_refs"] >= 1,
                "leak": obj["leak"],
                "candidate": obj in report["leak_candidates"]})
        finally:
            art.shutdown()
            cluster.shutdown()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] == {"nodes": 2, "copies": True, "sizes": True,
                           "owned": True, "leak": None, "candidate": False}


# ---------------------------------------------------------------------------
# one dashboard-enabled cluster of each package
# ---------------------------------------------------------------------------


_SETTINGS = {"ART_INCLUDE_DASHBOARD": "1", "ART_RECORD_OBJECT_CALLSITE": "1"}


@pytest.fixture(scope="module")
def clusters():
    prior = {k: os.environ.get(k) for k in _SETTINGS}
    os.environ.update(_SETTINGS)
    try:
        out = {}
        for art in PACKAGES:
            ctx = art.init(num_cpus=2)
            assert ctx.dashboard_url, "dashboard did not start"
            rt = _mod(art, "_private.worker").global_worker.runtime
            out[art] = {"dashboard": ctx.dashboard_url,
                        "gcs": rt.gcs_address,
                        "fns": _functions(art)}
        yield out
    finally:
        for art in PACKAGES:
            art.shutdown()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _functions(art):
    @art.remote
    def obs_ok(x):
        return x + 1

    @art.remote
    def obs_fail():
        raise ValueError("observatory boom")

    @art.remote(max_retries=1)
    def obs_flaky(path):
        if not os.path.exists(path):
            open(path, "w").close()
            task_events = importlib.import_module(
                art.__name__ + "._private.task_events")
            task_events.flush()
            os._exit(1)
        return "ok"

    return {"ok": obs_ok, "fail": obs_fail, "flaky": obs_flaky}


def _each(clusters, scenario):
    got = [scenario(art, clusters[art]) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def test_server_side_list_filters_and_get(clusters):
    def scenario(art, c):
        state = _mod(art, "util.state")
        ok, fail = c["fns"]["ok"], c["fns"]["fail"]
        assert art.get([ok.remote(i) for i in range(6)]) == \
            list(range(1, 7))
        try:
            art.get(fail.remote())
        except Exception as e:  # noqa: BLE001
            assert "observatory boom" in str(e)
        name = ok.function_name
        rows = _wait_for(lambda: (lambda r: r if len(r) >= 6 else None)(
            state.list_tasks(name=name, state="FINISHED")))
        failed = _wait_for(lambda: [
            r for r in state.list_tasks(state="FAILED")
            if r["name"].endswith("obs_fail")] or None)
        got = state.get_task(failed[0]["task_id"])
        summary = state.summarize_tasks()
        group = summary["summary"][name]
        return {"finished": all(r["state"] == "FINISHED" and
                                r["run_s"] is not None for r in rows),
                "record_keys": sorted(rows[0]),
                "error": "observatory boom" in failed[0]["error"],
                "attempt_state": got["attempts"][0]["state"],
                "stats_keys": sorted(got["stats"]),
                "group": (group["state_counts"].get("FINISHED", 0) >= 6,
                          group["run_s"]["count"] >= 6),
                "summary_keys": sorted(summary)}

    out = _each(clusters, scenario)
    assert out["finished"] and out["error"]
    assert out["attempt_state"] == "FAILED"


def test_server_side_pagination(clusters):
    def scenario(art, c):
        state = _mod(art, "util.state")
        ok = c["fns"]["ok"]
        art.get([ok.remote(i) for i in range(11)])
        _wait_for(lambda: len(state.list_tasks(
            name=ok.function_name, state="FINISHED")) >= 11 or None)
        seen, token, pages = [], None, 0
        while True:
            reply = state.list_tasks_page(limit=4, token=token,
                                          name=ok.function_name)
            pages += 1
            seen.extend(r["task_id"] + f"#{r['attempt']}"
                        for r in reply["tasks"])
            token = reply["next_token"]
            if token is None:
                break
        return len(seen) == len(set(seen)) >= 11, sorted(reply)

    assert _each(clusters, scenario)[0]


def test_retried_task_attempts_server_side(clusters, tmp_path):
    def scenario(art, c):
        state = _mod(art, "util.state")
        flaky = c["fns"]["flaky"]
        marker = str(tmp_path / f"marker_{art.__name__}")
        assert art.get(flaky.remote(marker)) == "ok"

        def attempts():
            rows = state.list_tasks(name=flaky.function_name)
            by_attempt = {r["attempt"]: r for r in rows}
            if by_attempt.get(1, {}).get("state") == "FINISHED" and \
                    0 in by_attempt:
                return by_attempt
            return None

        by_attempt = _wait_for(attempts)
        return (by_attempt[0]["state"] in ("RUNNING", "PENDING_EXECUTION"),
                by_attempt[1]["run_s"] is not None)

    assert _each(clusters, scenario) == (True, True)


def test_dashboard_state_routes(clusters):
    def scenario(art, c):
        url = c["dashboard"]
        art.get(c["fns"]["ok"].remote(1))
        ref = art.put(np.ones(200_000, dtype=np.uint8))

        def get(path):
            with urllib.request.urlopen(url + path, timeout=30) as r:
                return json.loads(r.read())

        reply = _wait_for(lambda: (lambda r: r if r["tasks"] else None)(
            get("/api/tasks?state=FINISHED&limit=2")))
        summary = get("/api/tasks/summary")
        objects = _wait_for(lambda: [
            o for o in get("/api/objects")
            if o["object_id"] == ref.id.hex() and o["size"]] or None)
        memory = get("/api/memory?top=5")
        big = [o for o in memory["objects"]
               if o["object_id"] == objects[0]["object_id"]]
        del ref
        return {"tasks": (len(reply["tasks"]) <= 2, sorted(reply)),
                "summary": bool(summary["summary"]),
                "tier": objects[0]["copies"][0]["tier"],
                "owner": bool(objects[0]["owner"]),
                "object_keys": sorted(objects[0]),
                "memory_keys": sorted(memory),
                "capacity": bool(memory["nodes"][0]["capacity"]),
                "refs": bool(big) and big[0]["refs"] is not None}

    out = _each(clusters, scenario)
    assert out["tier"] in ("arena", "file") and out["refs"]


def test_record_object_callsite_knob(clusters):
    def scenario(art, _c):
        state = _mod(art, "util.state")
        ref = art.put(np.ones(200_000, dtype=np.uint8))

        def with_callsite():
            objs = [o for o in state.list_objects()
                    if o["object_id"] == ref.id.hex()]
            return objs if objs and objs[0]["callsite"] else None

        (obj,) = _wait_for(with_callsite, timeout=10)
        del ref
        return "test_torch_state.py" in obj["callsite"]

    assert _each(clusters, scenario) is True


def test_state_api_lists_and_logs(clusters):
    """list_nodes / list_actors / list_placement_groups / list_jobs /
    list_logs / get_log / summarize_cluster through each package."""
    def scenario(art, c):
        state = _mod(art, "util.state")
        pg_mod = _mod(art, "util.placement_group")

        @art.remote
        class Marker:
            def ping(self):
                return 1

        m = Marker.options(name="marked").remote()
        art.get(m.ping.remote())
        pg = pg_mod.placement_group([{"CPU": 1}], name="state-pg")
        assert pg.ready(timeout=30)
        nodes = state.list_nodes()
        actors = [a for a in state.list_actors() if a.name == "marked"]
        pgs = state.list_placement_groups()
        jobs = state.list_jobs()
        listing = state.list_logs()
        names = [f["filename"] for f in listing["files"]]
        worker_log = next(n for n in names if n.startswith("worker-"))
        text = state.get_log(worker_log, tail=2048)
        summary = state.summarize_cluster()
        art.kill(m)
        pg_mod.remove_placement_group(pg)
        return {"nodes": [(n.alive, sorted(n.total_resources))
                          for n in nodes],
                "actor": (actors[0].state, actors[0].class_name),
                "pg": sorted((e["name"], e["state"]) for e in pgs.values()
                             if e["name"] == "state-pg"),
                "jobs": (len(jobs) >= 1, sorted(jobs[0])),
                "logs": ("gcs.err" in names, isinstance(text, str)),
                "summary": (sorted(summary), summary["nodes"])}

    out = _each(clusters, scenario)
    assert out["actor"] == ("ALIVE", "Marker")
    assert out["pg"] == [("state-pg", "CREATED")]


def _cli(art, gcs, *args, json_out=True):
    env = dict(os.environ, ART_ADDRESS=gcs, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    argv = [sys.executable, "-m", art.__name__,
            *(["--json"] if json_out else []), *args]
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout) if json_out else proc.stdout


def test_cli_smoke_json(clusters):
    def scenario(art, c):
        art.get([c["fns"]["ok"].remote(i) for i in range(2)])
        ref = art.put(np.ones(150_000, dtype=np.uint8))
        status = _cli(art, c["gcs"], "status")
        reply = _wait_for(lambda: (lambda r: r if r["tasks"] else None)(
            _cli(art, c["gcs"], "list", "tasks", "--state", "FINISHED",
                 "--limit", "3")), timeout=30)
        summary = _cli(art, c["gcs"], "summary", "tasks")
        memory = _cli(art, c["gcs"], "memory", "--top", "5")
        nodes = _cli(art, c["gcs"], "list", "nodes")
        jobs = _cli(art, c["gcs"], "list", "jobs")
        pgs = _cli(art, c["gcs"], "list", "placement-groups")
        actors = _cli(art, c["gcs"], "list", "actors")
        logs = _cli(art, c["gcs"], "logs")
        human = _cli(art, c["gcs"], "status", json_out=False)
        del ref
        return {"status": (sorted(status), status["nodes"]["alive"] >= 1,
                           status["object_store"]["capacity"] > 0),
                "tasks": all(t["state"] == "FINISHED"
                             for t in reply["tasks"]),
                "summary": bool(summary["summary"]),
                "memory": (sorted(memory), memory["totals"]["objects"] >= 1),
                "nodes": (sorted(nodes), nodes["nodes"][0]["alive"],
                          nodes["next_token"]),
                "jobs": bool(jobs and jobs[0]["job_id"]),
                "pgs": isinstance(pgs, list),
                "actors": isinstance(actors, list),
                "logs": sorted(logs[0]),
                "human": "nodes" in human}

    out = _each(clusters, scenario)
    assert out["tasks"] and out["jobs"] and out["human"]


def test_cli_profile_and_diff(clusters, tmp_path):
    """``profile --out`` captures the cluster's folded stacks over a
    window longer than the publish period (2.5 s), so every process
    class published into it, and ``profile --diff`` ranks two
    captures without a cluster."""
    def scenario(art, c):
        a = str(tmp_path / f"{art.__name__}_a.json")
        capture = _cli(art, c["gcs"], "profile", "--duration", "3.0",
                       "--out", a)
        diff = _cli(art, c["gcs"], "profile", "--diff", a, a)
        return (sorted(capture), {"driver", "gcs", "daemon"}
                <= set(capture["procs"]), capture["samples"] > 0,
                sorted(diff), diff["frames"])

    out = _each(clusters, scenario)
    assert out[1] and out[2] and out[4] == []


@pytest.mark.parametrize("art", PACKAGES, ids=["jax", "port"])
def test_cli_errors_without_address(art):
    env = {k: v for k, v in os.environ.items() if k != "ART_ADDRESS"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", art.__name__, "status"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 2
    assert "ART_ADDRESS" in proc.stderr


def test_cli_scale_report_reads_only_the_file_it_is_given(tmp_path):
    """Without ``--file`` and without a cluster there is nothing to
    report; with a sweep file it renders the file."""
    env = {k: v for k, v in os.environ.items() if k != "ART_ADDRESS"}
    env["PYTHONPATH"] = REPO
    run = [sys.executable, "-m", "ant_ray_tpu_torch", "scale-report"]
    proc = subprocess.run(run, capture_output=True, text=True, env=env,
                          timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 2 and "--file" in proc.stderr
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps({"config": {"cpu_count": 2}, "sweep": [
        {"nodes": 10, "leases_per_s": 123.0}]}))
    proc = subprocess.run(run + ["--file", str(sweep)], capture_output=True,
                          text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "123.000" in proc.stdout
