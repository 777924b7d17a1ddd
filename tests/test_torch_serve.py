"""The port's Serve (serve/api.py) against the JAX package's: each
scenario of tests/test_serve.py runs through both packages, each in its
own cluster (started without ``_system_config``: both packages read
the same ``ART_*`` variables), and keeps the reference's assertions;
the two outcomes must then be equal — response values, HTTP status
codes and bodies, stream items, batch totals, replica counts and
multiplexing affinity.  Routing decisions (power-of-two choices, the
circuit breaker) are compared through their functions on fake replicas
with one seed.  Also the exported surface (``serve.__all__``)."""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.serve as jserve
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.serve as tserve

WAIT_S = 60


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tserve.shutdown()
            tart.shutdown()
    finally:
        jserve.shutdown()
        jart.shutdown()


PACKAGES = ((jart, jserve), (tart, tserve))


def _both(scenario):
    """Run ``scenario(art, serve)`` through the JAX package, then the
    port, shutting Serve down after each; returns (want, got)."""
    outs = []
    for art, serve in PACKAGES:
        try:
            outs.append(scenario(art, serve))
        finally:
            serve.shutdown()
    return tuple(outs)


def test_exported_surface_matches_jax():
    assert tserve.__all__ == jserve.__all__
    assert tserve.CONTROLLER_NAME == jserve.CONTROLLER_NAME
    for name in ("AutoscalingConfig", "RequestRetryConfig",
                 "CircuitBreakerConfig"):
        want = getattr(jserve, name)()
        got = getattr(tserve, name)()
        assert got.__dict__ == want.__dict__, name
    dep = tserve.deployment(lambda x: x, name="f")
    assert set(dep.__dict__) == set(
        jserve.deployment(lambda x: x, name="f").__dict__)
    assert tserve.get_request_deadline() is None
    assert tserve.get_multiplexed_model_id() == ""


def test_function_deployment(clusters):
    def scenario(art, serve):
        @serve.deployment
        def double(x):
            return x * 2

        handle = serve.run(double.bind())
        return art.get(handle.remote(21), timeout=WAIT_S)

    assert _both(scenario) == (42, 42)


def test_class_deployment_with_state(clusters):
    def scenario(art, serve):
        @serve.deployment(name="counter")
        class Counter:
            def __init__(self, start):
                self.n = start

            def __call__(self, k):
                self.n += k
                return self.n

            def peek(self):
                return self.n

        handle = serve.run(Counter.bind(100))
        return (art.get(handle.remote(5), timeout=WAIT_S),
                art.get(handle.options(method_name="peek").remote(),
                        timeout=WAIT_S))

    assert _both(scenario) == ((105, 105), (105, 105))


def test_multi_replica_distribution(clusters):
    def scenario(art, serve):
        @serve.deployment(name="who", num_replicas=2)
        class Who:
            def __call__(self):
                import os

                return os.getpid()

        handle = serve.run(Who.bind())
        pids = set(art.get([handle.remote() for _ in range(8)],
                           timeout=WAIT_S))
        return len(pids)

    assert _both(scenario) == (2, 2)


def test_redeploy_replaces_replicas(clusters):
    def scenario(art, serve):
        @serve.deployment(name="ver")
        class V1:
            def __call__(self):
                return "v1"

        @serve.deployment(name="ver")
        class V2:
            def __call__(self):
                return "v2"

        h1 = serve.run(V1.bind())
        first = art.get(h1.remote(), timeout=WAIT_S)
        h2 = serve.run(V2.bind())
        return first, art.get(h2.remote(), timeout=WAIT_S)

    assert _both(scenario) == (("v1", "v2"), ("v1", "v2"))


def _http(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], \
                json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], json.loads(e.read())


def test_http_ingress(clusters):
    def scenario(art, serve):
        @serve.deployment(name="api", route_prefix="/api")
        class Api:
            def __call__(self, body):
                return {"echo": body.get("msg", ""),
                        "n": body.get("n", 0) + 1,
                        "path": body.get("__route_path__")}

        serve.run(Api.bind(), port=0)
        port = serve.api.run.last_http_port
        assert port
        return (_http(port, "/api", {"msg": "hi", "n": 41}),
                _http(port, "/api/sub", {"n": 1}),
                _http(port, "/nope"))

    want, got = _both(scenario)
    assert got == want
    assert got[0] == (200, "application/json; charset=utf-8",
                      {"result": {"echo": "hi", "n": 42, "path": "/api"}})
    assert got[2][0] == 404


def test_streaming_handle(clusters):
    def scenario(art, serve):
        @serve.deployment(name="streamer")
        class Streamer:
            def stream(self, request):
                for i in range(int(request["n"])):
                    yield {"i": i}

        handle = serve.run(Streamer.bind())
        gen = handle.options(method_name="stream", stream=True).remote(
            {"n": 4})
        return [art.get(ref, timeout=WAIT_S) for ref in gen]

    want, got = _both(scenario)
    assert got == want == [{"i": 0}, {"i": 1}, {"i": 2}, {"i": 3}]


def test_batching_coalesces_requests(clusters):
    def scenario(art, serve):
        @serve.deployment(name="batched",
                          ray_actor_options={"max_concurrency": 16})
        class Batched:
            def __init__(self):
                self.batch_sizes = []

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
            def __call__(self, items):
                self.batch_sizes.append(len(items))
                return [x * 2 for x in items]

            def sizes(self):
                return self.batch_sizes

        handle = serve.run(Batched.bind())
        refs = [handle.remote(i) for i in range(8)]
        values = sorted(art.get(refs, timeout=WAIT_S))
        sizes = art.get(handle.options(method_name="sizes").remote(),
                        timeout=WAIT_S)
        # 8 concurrent requests must NOT take 8 model invocations.
        assert max(sizes) >= 2, sizes
        return values, sum(sizes)

    want, got = _both(scenario)
    assert got == want == ([i * 2 for i in range(8)], 8)


def _replica_count(art, serve, name):
    controller = art.get_actor(serve.CONTROLLER_NAME, namespace="_serve")
    info = art.get(controller.list_deployments.remote(), timeout=WAIT_S)
    return info[name]["num_replicas"]


def test_autoscaling_scales_on_target_signal(clusters):
    """One replica reports 5.0 of the target signal: ceil(5 / 2) = 3
    replicas while ongoing-request load is zero."""
    def scenario(art, serve):
        @serve.deployment(name="siggy",
                          autoscaling_config={
                              "min_replicas": 1, "max_replicas": 3,
                              "target_ongoing_requests": 100.0,
                              "interval_s": 0.3,
                              "target_signal": "art_llm_queue_depth",
                              "target_value": 2.0})
        class Siggy:
            def __call__(self, x):
                return x

            def load_signals(self):
                return {"art_llm_queue_depth": 5.0}

        serve.run(Siggy.bind())
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                _replica_count(art, serve, "siggy") < 3:
            time.sleep(0.25)
        return _replica_count(art, serve, "siggy")

    assert _both(scenario) == (3, 3)


def test_model_multiplexing(clusters):
    def scenario(art, serve):
        @serve.deployment(num_replicas=2)
        class MuxModel:
            def __init__(self):
                self.loads = []

            @serve.multiplexed(max_num_models_per_replica=1)
            def get_model(self, model_id):
                self.loads.append(model_id)
                return f"model-{model_id}"

            def __call__(self, x):
                import os

                model = self.get_model()
                return {"model": model, "pid": os.getpid(),
                        "loads": len(self.loads), "x": x,
                        "id": serve.get_multiplexed_model_id()}

        handle = serve.run(MuxModel.bind())
        a = [art.get(handle.options(multiplexed_model_id="a").remote(i),
                     timeout=WAIT_S) for i in range(4)]
        b = art.get(handle.options(multiplexed_model_id="b").remote(0),
                    timeout=WAIT_S)
        a2 = art.get(handle.options(multiplexed_model_id="a").remote(9),
                     timeout=WAIT_S)
        a_pids = {r["pid"] for r in a}
        return (len(a_pids), [(r["model"], r["id"], r["x"]) for r in a],
                (b["model"], b["id"]), a2["model"], a2["pid"] in a_pids,
                a2["loads"])

    want, got = _both(scenario)
    assert got == want
    assert got[0] == 1 and got[-1] == 1          # affinity, loaded once


# ------------------------------------------ routing decisions, one seed

class _FakeReplica:
    def __init__(self, i):
        self.actor_id = bytes([i]) * 16


def _routing_run(serve_api, seed):
    """Power-of-two choices over seeded queue depths, then breaker
    transitions driven by seeded outcomes (a probe due after the
    cooldown is forced by rewinding ``opened_at``)."""
    rng = np.random.default_rng(seed)
    replicas = [_FakeReplica(i) for i in range(5)]
    handle = serve_api.DeploymentHandle("d", replicas)
    routing = handle._routing
    routing.config = {"request_timeout_s": None,
                      "retry": serve_api.RequestRetryConfig(),
                      "breaker": serve_api.CircuitBreakerConfig(
                          window=6, min_outcomes=3, cooldown_s=0.5)}
    random.seed(seed)
    picks, states = [], []
    for step in range(60):
        if step % 10 == 0:
            routing.apply({"replicas": replicas,
                           "ongoing": rng.integers(0, 6, 5).tolist(),
                           "version": step})
        try:
            pick = handle._pick()
        except Exception as e:  # noqa: BLE001 — every replica ejected
            picks.append(type(e).__name__)
            continue
        index = replicas.index(pick)
        picks.append(index)
        routing.record_outcome(pick, bool(rng.random() < 0.3 + 0.15 * index))
        for br in routing.breakers.values():
            if br.state == "open":
                br.opened_at -= 1.0            # cooldown elapsed
        states.append(tuple(routing.breakers[r.actor_id].state
                            if r.actor_id in routing.breakers else "-"
                            for r in replicas))
    taken = routing.take_retry_token()
    return picks, states, taken, routing.retry_tokens


@pytest.mark.parametrize("seed", [0, 1])
def test_routing_decisions_match_jax(seed):
    want = _routing_run(jserve.api, seed)
    got = _routing_run(tserve.api, seed)
    assert got == want
    assert len(set(p for p in got[0] if isinstance(p, int))) >= 3
    assert any("open" in s for s in got[1])


def test_routing_shares_state_across_options_and_stays_on_its_family():
    replicas = [_FakeReplica(i) for i in range(3)]
    for serve_api in (jserve.api, tserve.api):
        handle = serve_api.DeploymentHandle("d", replicas)
        derived = handle.options(method_name="m", stream=True)
        assert derived._routing is handle._routing
        assert (derived._method, derived._stream) == ("m", True)
        back = type(handle)(*handle.__reduce__()[1])
        assert back._routing is not handle._routing
        assert back._routing.version == -1


def test_replica_admission_gate_in_process():
    """The replica's gate, driven directly: one slot, one queue seat;
    the third concurrent request sheds with the same typed error and
    message in both packages, and an expired deadline sheds before
    queueing."""
    def run(serve_api):
        gate = threading.Event()

        class Slow:
            def __call__(self):
                gate.wait(10)
                return "done"

        replica = serve_api.Replica(
            Slow, (), {}, {"deployment": "g", "max_ongoing_requests": 1,
                           "max_queued_requests": 1})
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(
                replica.handle_request("__call__", (), {})))
            for _ in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while replica.ongoing() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        outcomes = [replica.ongoing()]
        for meta in (None, {"deadline_ts": time.time() - 1}):
            try:
                replica.handle_request("__call__", (), {}, "", meta)
            except Exception as e:  # noqa: BLE001 — compared below
                outcomes.append((type(e).__name__, str(e).split(" (")[0]))
        gate.set()
        for t in threads:
            t.join()
        return outcomes, results, replica.ongoing()

    want = run(jserve.api)
    got = run(tserve.api)
    assert got == want
    assert got[0][0] == 2 and got[0][1][0] == "BackPressureError"
    assert got[0][2][0] == "DeadlineExceededError"
    assert got[1] == ["done", "done"] and got[2] == 0
