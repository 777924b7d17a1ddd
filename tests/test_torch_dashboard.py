"""The port's dashboard (``_private/dashboard.py``), node agent
(``_private/node_agent.py``), log serving and per-card gauges against the
JAX package's: the routes of tests/test_ops.py and
tests/test_observability.py, and the agent of tests/test_node_agent.py
(spawned and serving, restarted after a crash), each run against a
cluster of each package with the dashboard and the agent on, with equal
outcomes — statuses, key sets, series names.  On the CPU the agent's
device gauges are empty in both, and ``POST /api/profile`` archives a
trace of the agent's process (``jax.profiler`` in the reference,
``torch.profiler`` in the port, whose archive holds a Chrome trace).
Flow insight's route serves the same call graph in both; the agent's runtime-env build runs (job submission, export events and
runtime envs are held against the JAX package in tests/test_torch_job_
submission.py, test_torch_export_events.py and test_torch_runtime_env.py).
The card-wide memory reading the agent publishes is tested in
tests/test_torch_card_memory.py."""

from __future__ import annotations

import importlib
import json
import os
import signal
import tarfile
import time
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
_SETTINGS = {"ART_INCLUDE_DASHBOARD": "1", "ART_ENABLE_NODE_AGENT": "1",
             "ART_DEVICE_STATS_INTERVAL_S": "1.0"}


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _get(url, raw=False):
    with urllib.request.urlopen(url, timeout=30) as resp:
        body = resp.read().decode()
        return body if raw else json.loads(body)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read().decode())


def _shape(value):
    """The structure of a JSON reply: dict keys (recursively for the
    first item of lists), types elsewhere."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in sorted(value.items())}
    if isinstance(value, list):
        return ["list", _shape(value[0]) if value else None]
    return type(value).__name__


@pytest.fixture(scope="module")
def clusters():
    prior = {k: os.environ.get(k) for k in _SETTINGS}
    os.environ.update(_SETTINGS)
    for art in PACKAGES:
        _mod(art, "_private.config")._global_config = None
    try:
        out = {}
        for art in PACKAGES:
            ctx = art.init(num_cpus=2)
            assert ctx.dashboard_url, "dashboard did not start"
            rt = _mod(art, "_private.worker").global_worker.runtime
            out[art] = {"url": ctx.dashboard_url, "rt": rt}
        for art in PACKAGES:
            _agent_info(out[art]["rt"].node_address)
        yield out
    finally:
        for art in PACKAGES:
            art.shutdown()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for art in PACKAGES:
            _mod(art, "_private.config")._global_config = None


def _agent_info(node_address, timeout=30):
    from ant_ray_tpu_torch._private.protocol import ClientPool

    node = ClientPool().get(node_address)
    deadline = time.monotonic() + timeout
    info = None
    while time.monotonic() < deadline:
        info = node.call("GetAgentInfo", {}, timeout=5)
        if info["alive"] and info["address"]:
            return info
        time.sleep(0.2)
    raise AssertionError(f"agent never came up: {info}")


def _each(clusters, scenario):
    got = [scenario(art, clusters[art]) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def test_dashboard_state_endpoints(clusters):
    def scenario(art, c):
        base = c["url"]

        @art.remote
        class Marker:
            def ping(self):
                return 1

        m = Marker.options(name="marked").remote()
        art.get(m.ping.remote())
        pg_mod = _mod(art, "util.placement_group")
        pg = pg_mod.placement_group([{"CPU": 1}], name="dash-pg")
        assert pg.ready(timeout=30)
        nodes = _get(base + "/api/nodes")
        actors = _get(base + "/api/actors")
        status = _get(base + "/api/cluster_status")
        pgs = _get(base + "/api/placement_groups")
        out = {"nodes": (len(nodes), nodes[0]["alive"], _shape(nodes)),
               "marked": any(a["name"] == "marked" for a in actors),
               "status": (status["nodes_alive"],
                          status["resources_total"]["CPU"],
                          status["resources_available"]["CPU"],
                          sorted(status), status["ha"]["role"]),
               "pg": [(e["name"], e["state"]) for e in pgs.values()
                      if e["name"] == "dash-pg"],
               "ha": _shape(_get(base + "/api/ha")),
               "scale": sorted(_get(base + "/api/scale"))}
        art.kill(m)
        pg_mod.remove_placement_group(pg)
        return out

    out = _each(clusters, scenario)
    assert out["marked"] and out["pg"] == [("dash-pg", "CREATED")]
    assert out["status"][:3] == (1, 2.0, 1.0)


def test_observability_routes(clusters):
    """/api/timeline, /api/cpuprofile (the agent's records among the
    process classes), /api/trace/{id}, /api/flightrecorder and the UI."""
    def scenario(art, c):
        base = c["url"]

        @art.remote
        def traced_for_dash():
            return 1

        assert art.get(traced_for_dash.remote()) == 1
        slices = []
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not slices:
            slices = [t for t in _get(base + "/api/timeline")
                      if t.get("ph") == "X"
                      and t["name"].endswith("traced_for_dash")]
            time.sleep(0.3)
        procs = set()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not {
                "driver", "gcs", "daemon", "worker", "agent"} <= procs:
            profile = _get(base + "/api/cpuprofile")
            procs = set(profile["procs"])
            time.sleep(0.5)
        html = _get(base + "/", raw=True)
        return {"slices": bool(slices),
                "procs": {"driver", "gcs", "daemon", "worker",
                          "agent"} <= procs,
                "profile_keys": sorted(profile),
                "trace": _shape(_get(base + "/api/trace/" + "0" * 32)),
                "flight": (len(_get(base + "/api/flightrecorder")),
                           sorted(_get(base + "/api/flightrecorder")[0])),
                "ui": all(m in html for m in (
                    "ant-ray-tpu", "/api/cluster_status", "/api/nodes",
                    "overview"))}

    out = _each(clusters, scenario)
    assert out["slices"] and out["procs"] and out["ui"]


def test_prometheus_metrics_and_histograms(clusters):
    def scenario(art, c):
        metrics = _mod(art, "util.metrics")
        name = art.__name__.replace(".", "_")
        requests = metrics.Counter(f"{name}_requests",
                                   description="requests served",
                                   tag_keys=("route",))
        requests.inc(3, tags={"route": "/a"})
        requests.inc(2, tags={"route": "/a"})
        metrics.Gauge(f"{name}_queue_depth").set(7)
        lat = metrics.Histogram(f"{name}_latency_s", description="latency",
                                boundaries=[0.01, 0.1, 1.0],
                                tag_keys=("op",))
        for v in (0.005, 0.05, 0.5, 5.0, 0.06):
            lat.observe(v, tags={"op": "read"})
        time.sleep(0.5)
        text = _get(c["url"] + "/metrics", raw=True)
        lines = [line.replace(name, "<pkg>") for line in text.splitlines()
                 if line.startswith(name) or line.startswith(
                     f"# TYPE {name}")]
        return {"lines": sorted(lines),
                "builtin": all(s in text for s in (
                    "art_cluster_resource_total", "art_node_store_used_bytes{",
                    "art_node_workers{", 'node_id="')),
                "device_gauges": "art_device_hbm" in text}

    out = _each(clusters, scenario)
    assert '<pkg>_requests{route="/a"} 5.0' in out["lines"]
    assert '<pkg>_latency_s_bucket{op="read",le="0.1"} 3' in out["lines"]
    assert out["builtin"] and out["device_gauges"] is False


def test_log_monitor_endpoints(clusters):
    def scenario(art, c):
        @art.remote
        def noisy():
            print("hello from the worker")
            return 1

        assert art.get(noisy.remote()) == 1
        time.sleep(0.5)
        listing = _get(c["url"] + "/api/logs")
        names = [f["filename"] for f in listing[0]["files"]]
        worker_logs = [n for n in names if n.startswith("worker-")]
        body = _get(c["url"] + f"/api/logs/{worker_logs[0]}?tail=4096")
        missing = _get(c["url"] + "/api/logs/no-such.log")
        return {"listing": _shape(listing), "worker_logs": bool(worker_logs),
                "agent_log": "agent.err" in names,
                "body": (sorted(body), body["eof"]),
                "missing": sorted(missing)}

    out = _each(clusters, scenario)
    assert out["worker_logs"] and out["agent_log"] and out["body"][1]


def test_api_profile_roundtrip(clusters):
    """POST /api/profile routes to the node's agent, which archives a
    trace of its own process into the log dir; the log routes list and
    serve the archive.  The port's archive holds a Chrome trace."""
    def scenario(art, c):
        deadline = time.monotonic() + 60
        while True:
            reply = _post(c["url"] + "/api/profile", {"duration_s": 0.2})
            if "error" not in reply:
                break
            assert "agent" in reply["error"], reply
            assert time.monotonic() < deadline, reply
            time.sleep(0.5)
        logs = _get(c["url"] + "/api/logs")
        names = [f["filename"] for node in logs for f in node["files"]]
        served = _get(c["url"] + f"/api/logs/{reply['archive']}")
        return {"keys": sorted(reply),
                "archive": reply["archive"].endswith(".tar.gz"),
                "listed": reply["archive"] in names,
                "served": bool(served["data"]),
                "path": os.path.join(c["rt"].session_dir, "logs",
                                     reply["archive"])}

    outs = [scenario(art, clusters[art]) for art in PACKAGES]
    paths = [o.pop("path") for o in outs]
    assert outs[0] == outs[1]
    assert outs[1] == {"keys": ["archive", "duration_s", "node_id",
                                "trace_dir"],
                       "archive": True, "listed": True, "served": True}
    with tarfile.open(paths[1]) as tar:
        (member,) = [m for m in tar.getmembers()
                     if m.name.endswith("trace.json")]
        trace = json.load(tar.extractfile(member))
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]


def test_unported_routes_answer_501_naming_their_item(clusters):
    """No route answers 501 any more: ``/api/insight``, the last one
    (flow insight), serves the GCS ring's events and their call graph,
    equal to the JAX package's for the same events."""
    events = [
        *({"type": "call_submit", "function": "m.f", "task_id": f"t{i}",
           "caller": "driver", "ts": 1.0 + i, "source": "d"}
          for i in range(3)),
        {"type": "call_end", "function": "m.f", "task_id": "t0",
         "duration_s": 0.25, "error": False, "ts": 5.0, "source": "w"},
        {"type": "call_end", "function": "m.f", "task_id": "t1",
         "duration_s": 0.5, "error": True, "ts": 6.0, "source": "w"}]
    replies = []
    for art in PACKAGES:
        c = clusters[art]
        for event in events:
            c["rt"]._gcs.call("InsightRecord", event, timeout=30)
        reply = _get(c["url"] + "/api/insight")
        replies.append((reply["events"][-len(events):], reply["graph"]))
    assert replies[0] == replies[1]
    assert replies[1] == (events, {
        "edges": [{"caller": "driver", "callee": "m.f", "count": 3}],
        "functions": {"m.f": {"calls": 2, "errors": 1, "total_s": 0.75}}})


def _agent_pids(art, session_dir):
    module = f"{art.__name__}._private.node_agent".encode()
    out = []
    for pid in [int(p) for p in os.listdir("/proc") if p.isdigit()]:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if module in argv and session_dir.encode() in argv:
            out.append(pid)
    return out


def test_agent_spawned_serving_and_restarted_after_a_crash(clusters):
    def scenario(art, c):
        protocol = _mod(art, "_private.protocol")
        node_address = c["rt"].node_address
        info = _agent_info(node_address)
        agent = protocol.ClientPool().get(info["address"])
        served = {"ping": agent.call("Ping", {}, timeout=10),
                  "metrics": "mem_total_kb" in agent.call(
                      "AgentMetrics", {}, timeout=10),
                  "logs": any(e["filename"].startswith("worker-") for e in
                              agent.call("AgentListLogs", {}, timeout=10)),
                  "device_gauges": agent.call("AgentDeviceStats", {},
                                              timeout=60),
                  "device": agent.call("AgentStats", {}, timeout=60)[
                      "device"][0]["platform"]}
        pids = _agent_pids(art, c["rt"].session_dir)
        for pid in pids:
            os.kill(pid, signal.SIGKILL)
        node = protocol.ClientPool().get(node_address)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            info2 = node.call("GetAgentInfo", {}, timeout=5)
            if info2["alive"] and info2["address"] and \
                    info2["address"] != info["address"]:
                break
            time.sleep(0.3)
        back = protocol.ClientPool().get(info2["address"]).call(
            "Ping", {}, timeout=10)
        return {**served, "killed": len(pids),
                "restarts": info2["restarts"] >= 1, "back": back}

    out = _each(clusters, scenario)
    assert out == {"ping": "pong", "metrics": True, "logs": True,
                   "device_gauges": [], "device": "cpu", "killed": 1,
                   "restarts": True, "back": "pong"}


@pytest.fixture()
def lone_agent(tmp_path, monkeypatch):
    monkeypatch.setenv("ART_DEVICE_STATS_INTERVAL_S", "0")
    from ant_ray_tpu_torch._private import config as config_mod
    from ant_ray_tpu_torch._private.node_agent import NodeAgent

    config_mod._global_config = None
    agent = NodeAgent(str(tmp_path), gcs_address="127.0.0.1:1")
    agent.start()
    yield agent
    agent.stop()
    config_mod._global_config = None


def test_lone_agent_profile_log_serving_and_stats(lone_agent):
    """A port agent over a dead GCS address (tests/test_observability.py's
    lone agent): trace capture archives into the log dir, the agent's
    own log routes serve it, its stats count it, the CPU has no device
    gauges, and it builds a runtime env (one of env_vars alone: nothing
    to fetch from the dead GCS), counted in its stats."""
    from ant_ray_tpu_torch._private import log_serving
    from ant_ray_tpu_torch._private.protocol import ClientPool

    client = ClientPool().get(lone_agent.address)
    reply = client.call("AgentProfile", {"duration_s": 0.1}, timeout=120)
    assert "error" not in reply, reply
    assert reply["archive"].endswith(".tar.gz")
    assert os.path.isdir(reply["trace_dir"])
    files = [f["filename"]
             for f in log_serving.list_logs(str(lone_agent._session_dir))]
    assert reply["archive"] in files
    read = client.call("AgentReadLog", {"filename": reply["archive"]},
                       timeout=30)
    assert "error" not in read and len(read["data"]) > 0
    stats = client.call("AgentStats", {}, timeout=30)
    assert stats["profiles_captured"] == 1 and stats["log_reads"] == 1
    assert stats["device"] == [{"index": 0, "device": "cpu",
                                "platform": "cpu", "bytes_in_use": None,
                                "peak_bytes_in_use": None,
                                "bytes_limit": None}]
    assert client.call("AgentDeviceStats", {}, timeout=60) == []
    assert client.call("BuildRuntimeEnv",
                       {"wire": {"env_vars": {"A": "1"}}},
                       timeout=30) == {"ok": True}
    stats = client.call("AgentStats", {}, timeout=30)
    assert stats["env_builds"] == 1 and stats["env_build_failures"] == 0
