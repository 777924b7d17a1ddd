"""Serve rolling updates, the gRPC ingress and the autoscaler of the
port (serve/api.py) against the JAX package's: each scenario of
tests/test_serve_rollout.py runs through both packages, each in its own
cluster (started without ``_system_config``), and keeps the
reference's assertions; the outcomes — response versions, redeploy and
surge counts, gRPC replies and status codes — must then be equal.  The
controller's scaling decisions are compared through its scale loop,
driven one decision at a time on seeded queue depths and load signals
with the replica calls replaced."""

import json
import threading
import time
import types

import numpy as np
import pytest

import ant_ray_tpu.serve as jserve
import ant_ray_tpu_torch.serve as tserve
from test_torch_serve import _both, clusters  # noqa: F401 — the fixture

WAIT_S = 60


class Versioned:
    def __init__(self, version):
        self._version = version

    def __call__(self, request):
        time.sleep(0.01)
        return {"version": self._version, "echo": request.get("x")}

    def stream(self, request):
        for i in range(3):
            yield {"i": i, "version": self._version}


def test_rolling_update_zero_dropped_requests(clusters):
    def scenario(art, serve):
        dep = serve.deployment(Versioned, name="roll", num_replicas=3)
        handle = serve.run(dep.bind("v1"))
        results, errors = [], []
        stop = threading.Event()

        def hammer():
            i = 0
            while not stop.is_set():
                try:
                    results.append(art.get(handle.remote({"x": i}),
                                           timeout=30))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                i += 1

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.0)                      # sustained v1 load
        serve.run(dep.bind("v2"))            # rolling redeploy under load
        time.sleep(1.0)                      # sustained v2 load
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, f"dropped requests during rollout: {errors[:3]}"
        versions = [r["version"] for r in results]
        controller = art.get_actor(serve.CONTROLLER_NAME,
                                   namespace="_serve")
        info = art.get(controller.get_handle_info.remote("roll"),
                       timeout=WAIT_S)
        # once v2 appears it stays: replicas were replaced, not mixed
        return ("v1" in versions, "v2" in versions, versions[-1],
                len(info["replicas"]), len(errors))

    want, got = _both(scenario)
    assert got == want == (True, True, "v2", 3, 0)


def test_rolling_update_respects_surge_limit(clusters):
    def scenario(art, serve):
        dep = serve.deployment(Versioned, name="surge", num_replicas=2)
        serve.run(dep.bind("v1"))
        controller = art.get_actor(serve.CONTROLLER_NAME,
                                   namespace="_serve")
        peak = {"n": 0}
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                info = art.get(controller.get_handle_info.remote("surge"))
                if info:
                    peak["n"] = max(peak["n"], len(info["replicas"]))
                time.sleep(0.01)

        t = threading.Thread(target=watch)
        t.start()
        handle = serve.run(dep.bind("v2"))
        stop.set()
        t.join(timeout=10)
        after = art.get(controller.get_handle_info.remote("surge"))
        return (peak["n"] <= 3, len(after["replicas"]), after["version"],
                art.get(handle.remote({"x": 1}), timeout=WAIT_S))

    want, got = _both(scenario)
    # replicas are swapped in place: the routable set never exceeds
    # target; one version bump per swap of the two replicas
    assert got == want
    assert got[:2] == (True, 2) and got[3] == {"version": "v2", "echo": 1}


def test_grpc_ingress_unary_and_stream(clusters):
    grpc = pytest.importorskip("grpc")

    def scenario(art, serve):
        dep = serve.deployment(Versioned, name="grpcdep",
                               route_prefix="/api")
        serve.run(dep.bind("g1"), grpc_port=0)
        port = serve.run.last_grpc_port
        assert port
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            call = channel.unary_unary("/antray.serve.Ingress/Call")
            reply = json.loads(call(json.dumps(
                {"route": "/api", "request": {"x": 41}}).encode(),
                timeout=60))
            stream = channel.unary_stream("/antray.serve.Ingress/Stream")
            chunks = [json.loads(c) for c in stream(
                json.dumps({"route": "/api", "request": {}}).encode(),
                timeout=60)]
            codes = []
            for payload in (b'{"route": "/nope", "request": {}}',
                            b"not json"):
                try:
                    call(payload, timeout=30)
                    codes.append("ok")
                except grpc.RpcError as e:
                    codes.append(e.code().name)
            return reply, chunks, codes
        finally:
            channel.close()

    want, got = _both(scenario)
    assert got == want
    reply, chunks, codes = got
    assert reply["result"] == {"version": "g1", "echo": 41}
    assert [c["i"] for c in chunks] == [0, 1, 2]
    assert codes == ["NOT_FOUND", "INVALID_ARGUMENT"]


def test_redeploy_racing_delete_falls_through_to_fresh_deploy(clusters):
    """deploy() saw the app existing, but it was deleted before
    _rolling_redeploy took the lock: the roll must fall through to a
    fresh deploy, not return success with nothing deployed."""
    def scenario(art, serve):
        controller = serve.api.ServeController()
        try:
            dep = serve.deployment(Versioned, name="raced", num_replicas=1)
            controller.deploy(dep, ("v1",), {})
            assert "raced" in controller._deployments
            with controller._lock:
                controller._deployments.pop("raced")
            out = controller._rolling_redeploy(dep.options(name="raced"),
                                               ("v2",), {})
            entry = controller._deployments.get("raced")
            got = art.get(entry["replicas"][0].handle_request.remote(
                "__call__", ({"x": 7},), {}), timeout=WAIT_S)
            return out, len(entry["replicas"]), got
        finally:
            controller._stopping = True
            for entry in controller._deployments.values():
                for replica in entry["replicas"]:
                    try:
                        art.kill(replica)
                    except Exception:  # noqa: BLE001
                        pass
            # The controller's loops run in this process: none may
            # outlive the cluster (its next API call would start one).
            for loop in (controller._scaler, controller._drainer):
                loop.join(timeout=WAIT_S)
                assert not loop.is_alive(), loop.name

    want, got = _both(scenario)
    assert got == want == ({"name": "raced"}, 1,
                           {"version": "v2", "echo": 7})


# ------------------------------------------- autoscaling decisions, seeded

class _FakeReplica:
    def __init__(self, i):
        self.actor_id = bytes([i + 1]) * 16


def _scaling_run(serve_api, seed, signal, monkeypatch):
    """Drive the controller's scale loop one decision at a time: queue
    depths and load signals come from a seeded generator, and the
    replica calls (polls, replica starts, drains) are replaced by
    recorders.  Returns every decision."""
    rng = np.random.default_rng(seed)
    cfg = serve_api.AutoscalingConfig(
        min_replicas=1, max_replicas=5, target_ongoing_requests=2.0,
        interval_s=0.0, downscale_patience=2,
        target_signal="art_llm_queue_depth" if signal else None,
        target_value=3.0)
    dep = serve_api.Deployment(cls_or_fn=object, name="d",
                               autoscaling_config=cfg)
    ctl = object.__new__(serve_api.ServeController)
    ctl._lock = threading.Lock()
    ctl._version_cv = threading.Condition(ctl._lock)
    ctl._stopping = False
    ctl._proxy = None
    ctl._deployments = {"d": {
        "deployment": dep, "args": (), "kwargs": {},
        "replicas": [_FakeReplica(0)], "route_prefix": None,
        "ongoing": [0], "low_streak": 0, "version": 0, "strikes": {},
        "suspect": set()}}
    decisions = []
    rounds = iter(range(12))

    def poll(entries):
        if next(rounds, None) is None:
            ctl._stopping = True
            return {}
        return {name: rng.integers(0, 5, len(replicas)).tolist()
                for name, replicas in entries}

    def signal_total(replicas, name):
        return float(rng.integers(0, 4, len(replicas)).sum())

    def scale_up(name, count):
        decisions.append(("up", count))
        entry = ctl._deployments[name]
        n = len(entry["replicas"])
        entry["replicas"] = entry["replicas"] + [
            _FakeReplica(n + i) for i in range(count)]
        entry["low_streak"] = 0

    def scale_down(name, count):
        decisions.append(("down", count))
        entry = ctl._deployments[name]
        entry["replicas"] = entry["replicas"][:-count]
        entry["low_streak"] = 0

    ctl._poll_ongoing_all = poll
    ctl._poll_signal_total = signal_total
    ctl._scale_up = scale_up
    ctl._scale_down = scale_down
    # The loop's 0.25 s pause is skipped in this thread only.
    me = threading.current_thread()
    monkeypatch.setattr(serve_api, "time", types.SimpleNamespace(
        monotonic=time.monotonic, time=time.time,
        perf_counter=time.perf_counter,
        sleep=lambda s: (None if threading.current_thread() is me
                         else time.sleep(s))))
    try:
        ctl._scale_loop()
    finally:
        monkeypatch.undo()
    return decisions, len(ctl._deployments["d"]["replicas"])


@pytest.mark.parametrize("signal", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_autoscaling_decisions_match_jax(seed, signal, monkeypatch):
    want = _scaling_run(jserve.api, seed, signal, monkeypatch)
    got = _scaling_run(tserve.api, seed, signal, monkeypatch)
    assert got == want
    assert any(d[0] == "up" for d in got[0])
