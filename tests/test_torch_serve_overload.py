"""The overload plane of the port's Serve (serve/api.py) against the JAX
package's: replica-side admission with load shedding, end-to-end
deadlines (expired work is shed, never executed), deadline-aware
``@serve.batch`` flushing, the HTTP and gRPC shed contracts, circuit
breakers and retry budgets.  Each scenario of
tests/test_serve_overload.py that needs no ``util/chaos`` runs through
both packages, each in its own cluster (started without
``_system_config``: both packages read the same ``ART_*`` variables;
the reference's module runs under injected RPC latency, which is not
ported), keeps the reference's assertions, and the outcomes must be
equal: status codes, headers and bodies, gRPC status codes, shed
messages (numbers masked), executed ids and invocation counts."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.serve as jserve
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.serve as tserve
from test_torch_serve import clusters  # noqa: F401 — the fixture
from ant_ray_tpu.exceptions import BackPressureError as JaxBackPressure
from ant_ray_tpu.exceptions import DeadlineExceededError as JaxDeadline
from ant_ray_tpu.exceptions import TaskCancelledError as JaxCancelled
from ant_ray_tpu_torch.exceptions import (BackPressureError,
                                          DeadlineExceededError,
                                          TaskCancelledError)

PACKAGES = {"jax": (jart, jserve, JaxBackPressure, JaxDeadline,
                    JaxCancelled),
            "torch": (tart, tserve, BackPressureError,
                      DeadlineExceededError, TaskCancelledError)}


def _both(scenario):
    return tuple(scenario(*PACKAGES[p]) for p in ("jax", "torch"))


def _mask(message: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "<n>", message)


def _concurrent(fn, n):
    """Run fn(i) on n threads behind a start barrier; returns what the
    calls returned."""
    out = []
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        out.append(fn(i))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


class Cap:
    def __call__(self, body=None):
        sleep_s = 0.3
        if isinstance(body, dict):
            sleep_s = float(body.get("sleep_s", 0.3))
        time.sleep(sleep_s)
        return "done"


@pytest.fixture(scope="module")
def caps(clusters):
    """ONE bounded deployment + both ingresses per package, shared by the
    admission and ingress contract tests."""
    out = {}
    for name, (art, serve, *_errors) in PACKAGES.items():
        dep = serve.deployment(Cap, name="cap", route_prefix="/cap",
                               max_ongoing_requests=1,
                               max_queued_requests=1)
        handle = serve.run(dep.bind(), port=0, grpc_port=0)
        out[name] = (handle, serve.api.run.last_http_port,
                     serve.run.last_grpc_port)
    return out


# --------------------------------------------------------- admission


def test_admission_sheds_at_capacity(caps):
    """max_ongoing + max_queued bound the replica; excess fast-fails
    with a typed BackPressureError carrying a Retry-After hint."""
    def scenario(art, serve, backpressure, *_):
        handle = caps["jax" if art is jart else "torch"][0]

        def call(i):
            try:
                return ("ok", handle.call({"sleep_s": 0.3}))
            except backpressure as e:
                return ("shed", e.retry_after_s, _mask(str(e)))

        results = _concurrent(call, 6)
        ok = [r for r in results if r[0] == "ok"]
        shed = [r for r in results if r[0] == "shed"]
        # 1 running + 1 queued admitted; the others shed (thread-start
        # skew can let a queued one finish first, freeing a slot).
        assert len(ok) >= 2, results
        assert len(shed) >= 3, results
        assert all(r[1] > 0 for r in shed), results
        return {r[1] for r in ok}, {r[2] for r in shed}

    want, got = _both(scenario)
    assert got == want
    assert got[1] == {"replica at capacity (<n> running, <n> queued)"}


def test_serve_metrics_instruments():
    want = {m._name for m in jserve.api._metrics().values()}
    got = {m._name for m in tserve.api._metrics().values()}
    assert got == want == {
        "art_serve_shed_requests_total", "art_serve_queue_depth",
        "art_serve_breaker_state", "art_serve_suspect_replicas",
        "art_serve_retries_total",
        "art_serve_retry_budget_exhausted_total"}


# --------------------------------------------------------- deadlines


class DlShed:
    def __init__(self):
        self.executed = []

    def __call__(self, i, sleep_s=0.0):
        self.executed.append(i)
        time.sleep(sleep_s)
        return i

    def executed_ids(self):
        return list(self.executed)


def test_deadline_sheds_queued_work_never_executed(clusters):
    """A request whose deadline expires while queued for a replica slot
    is never executed, and the deployment's request_timeout_s default
    stamps calls that set no explicit timeout."""
    def scenario(art, serve, _bp, deadline_error, _c):
        dep = serve.deployment(DlShed, name="dlshed",
                               max_ongoing_requests=1,
                               max_queued_requests=8,
                               request_timeout_s=0.25)
        h = serve.run(dep.bind())
        occupier_result = []

        def occupy():
            try:
                occupier_result.append(("ok", h.call(0, sleep_s=0.6)))
            except deadline_error as e:
                occupier_result.append(("deadline", _mask(str(e))))

        occupier = threading.Thread(target=occupy)
        occupier.start()
        time.sleep(0.2)                  # let it take the only slot

        def call(i):
            try:
                return ("ok", h.call(i + 1, timeout_s=0.25))
            except deadline_error:
                return ("deadline", i + 1)

        results = sorted(_concurrent(call, 3))
        occupier.join()
        time.sleep(0.3)
        executed = h.options(method_name="executed_ids").call()
        return occupier_result, results, executed

    want, got = _both(scenario)
    assert got == want
    occupier, results, executed = got
    assert occupier == [("deadline", "dlshed: no reply within <n>s "
                         "(attempt <n>)")]
    assert results == [("deadline", 1), ("deadline", 2), ("deadline", 3)]
    assert executed == [0]


class Slow:
    def __init__(self):
        self.ran = []

    def work(self, i, sleep_s=0.0):
        self.ran.append(i)
        time.sleep(sleep_s)
        return i

    def ran_ids(self):
        return list(self.ran)


def test_cancel_reaps_queued_actor_task(clusters):
    """art.cancel on a not-yet-executing actor task: the call fails
    with TaskCancelledError and the method body never runs."""
    def scenario(art, _serve, _bp, _dl, cancelled):
        actor = art.remote(Slow).remote()
        first = actor.work.remote(0, sleep_s=0.6)   # occupies the executor
        time.sleep(0.1)
        queued = actor.work.remote(1)
        art.cancel(queued)
        try:
            art.get(queued, timeout=10)
            outcome = "ran"
        except Exception as e:  # noqa: BLE001 — checked below
            outcome = (isinstance(e, cancelled) or isinstance(
                getattr(e, "cause", None), cancelled))
        out = (outcome, art.get(first, timeout=10),
               art.get(actor.ran_ids.remote(), timeout=10))
        art.kill(actor)
        return out

    want, got = _both(scenario)
    assert got == want == (True, 0, [0])


# --------------------------------------------------------- @serve.batch


def test_batch_deadline_pulls_flush_forward(clusters):
    """A tight end-to-end deadline flushes the batch EARLY, instead of
    parking the item for the full batch window."""
    def scenario(art, serve, *_):
        @serve.deployment(name="batchpull",
                          ray_actor_options={"max_concurrency": 16})
        class Batchy:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=5.0)
            def __call__(self, items):
                return [x * 2 for x in items]

        h = serve.run(Batchy.bind())
        t0 = time.perf_counter()
        value = h.call(21, timeout_s=0.8)
        elapsed = time.perf_counter() - t0
        # Served before its 0.8 s deadline, nowhere near the 5 s window.
        assert 0.3 < elapsed < 2.0, elapsed
        return value

    assert _both(scenario) == (42, 42)


def test_batch_expired_items_shed_not_executed():
    """An item whose deadline has already expired by flush time is shed
    with the typed error and never reaches the model function; live
    batch-mates still execute (in-process: the deadline context is set
    directly)."""
    def scenario(_art, serve, _bp, deadline_error, _c):
        serve_api = serve.api

        class Model:
            def __init__(self):
                self.seen = []

            @serve_api.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
            def fn(self, items):
                self.seen.extend(items)
                return [x * 2 for x in items]

        m = Model()
        results = {}

        def call(i, deadline_offset):
            token = serve_api._request_deadline.set(
                None if deadline_offset is None
                else time.time() + deadline_offset)
            try:
                results[i] = ("ok", m.fn(i))
            except deadline_error as e:
                results[i] = ("shed", _mask(str(e)))
            finally:
                serve_api._request_deadline.reset(token)

        live = threading.Thread(target=call, args=(0, None))
        expired = threading.Thread(target=call, args=(1, -0.05))
        live.start()
        expired.start()
        live.join()
        expired.join()
        return results, m.seen

    want, got = _both(scenario)
    assert got == want
    results, seen = got
    assert results == {0: ("ok", 0), 1: (
        "shed", "request deadline expired <n>s before batch flush")}
    assert seen == [0]


def test_batch_flush_is_event_driven(clusters):
    """A full batch flushes the moment its last item lands."""
    def scenario(art, serve, *_):
        @serve.deployment(name="batchcv",
                          ray_actor_options={"max_concurrency": 16})
        class Batchy:
            @serve.batch(max_batch_size=4, batch_wait_timeout_s=10.0)
            def __call__(self, items):
                return [x + 1 for x in items]

        h = serve.run(Batchy.bind())
        t0 = time.perf_counter()
        results = _concurrent(lambda i: h.call(i, timeout_s=5.0), 4)
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.9, elapsed
        return sorted(results)

    assert _both(scenario) == ([1, 2, 3, 4], [1, 2, 3, 4])


# --------------------------------------------------------- ingress contracts


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _contract(code, headers, raw):
    """What a client reads of a reply: status, content type, the
    Retry-After header, and the body's keys (values masked)."""
    body = json.loads(raw) if raw else None
    shape = (tuple(sorted(body)) if isinstance(body, dict) else body)
    err = body.get("error") if isinstance(body, dict) else None
    return (code, headers.get("Content-Type"),
            "Retry-After" in headers, shape,
            _mask(err) if isinstance(err, str) else None)


def test_http_contract_429_retry_after_and_504(caps):
    """Sheds surface as HTTP 429 + Retry-After (integral, >= 1),
    deadline misses as 504, and a malformed timeout header as 400."""
    def scenario(art, *_):
        port = caps["jax" if art is jart else "torch"][1]
        assert port
        replies = _concurrent(
            lambda i: _post(port, "/cap", {"sleep_s": 0.35}), 5)
        by_code = {}
        for code, headers, raw in replies:
            by_code.setdefault(code, []).append((headers, raw))
        assert 200 in by_code and 429 in by_code, replies
        for headers, raw in by_code[429]:
            assert int(headers["Retry-After"]) >= 1
            assert json.loads(raw)["retry_after_s"] > 0
        return ({_contract(c, h, r) for c, h, r in replies},
                _contract(*_post(port, "/cap", {"sleep_s": 0.45},
                                 {"X-Request-Timeout-S": "0.2"})),
                _contract(*_post(port, "/cap", {"sleep_s": 0},
                                 {"X-Request-Timeout-S": "soon"})))

    want, got = _both(scenario)
    assert got == want
    mixed, deadline, malformed = got
    assert (200, "application/json; charset=utf-8", False, ("result",),
            None) in mixed
    assert (429, "application/json; charset=utf-8", True,
            ("error", "retry_after_s"),
            "replica at capacity (<n> running, <n> queued)") in mixed
    assert deadline == (504, "application/json; charset=utf-8", False,
                        ("error",), "cap: no reply within <n>s "
                        "(attempt <n>)")
    assert malformed[0] == 400


def test_grpc_contract_resource_exhausted_and_deadline(caps):
    """gRPC: sheds map to RESOURCE_EXHAUSTED with a retry-after-s
    trailer; deadline misses to DEADLINE_EXCEEDED."""
    grpc = pytest.importorskip("grpc")

    def scenario(art, *_):
        port = caps["jax" if art is jart else "torch"][2]
        assert port
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = channel.unary_unary("/antray.serve.Ingress/Call")

        def rpc(payload):
            try:
                reply = call(json.dumps({"route": "/cap",
                                         "request": payload}).encode(),
                             timeout=30)
                return ("ok", json.loads(reply))
            except grpc.RpcError as e:
                return ("err", e)

        try:
            results = _concurrent(lambda i: rpc({"sleep_s": 0.35}), 5)
            oks = [r[1] for r in results if r[0] == "ok"]
            errs = [r[1] for r in results if r[0] == "err"]
            assert oks and errs, results
            exhausted = [e for e in errs
                         if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED]
            assert exhausted, [e.code() for e in errs]
            trailers = dict(exhausted[0].trailing_metadata() or ())
            assert float(trailers["retry-after-s"]) > 0
            tag, e = rpc({"sleep_s": 0.45, "timeout_s": 0.2})
            return ({json.dumps(o) for o in oks},
                    {(e.code().name, _mask(e.details())) for e in errs},
                    sorted(trailers), tag, e.code().name,
                    _mask(e.details()))
        finally:
            channel.close()

    want, got = _both(scenario)
    assert got == want
    assert got[0] == {'{"result": "done"}'}
    assert ("RESOURCE_EXHAUSTED",
            "replica at capacity (<n> running, <n> queued)") in got[1]
    assert got[3:5] == ("err", "DEADLINE_EXCEEDED")


def test_http_stream_shed_surfaces_429(clusters):
    """Streaming requests honor the same shed contract as unary ones:
    the first chunk is pulled BEFORE the SSE headers go out."""
    def scenario(art, serve, *_):
        @serve.deployment(name="sse", route_prefix="/sse",
                          max_ongoing_requests=1, max_queued_requests=0)
        class Sse:
            def __call__(self, body=None):
                time.sleep(float(body.get("sleep_s", 0.2))
                           if isinstance(body, dict) else 0.2)
                return "done"

            def stream(self, body=None):
                for i in range(3):
                    yield {"i": i}

        h = serve.run(Sse.bind(), port=0)
        port = serve.api.run.last_http_port
        assert port
        code, headers, raw = _post(port, "/sse", {"stream": True})
        happy = (code, headers["Content-Type"],
                 [ln for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")])
        blocker = threading.Thread(
            target=lambda: h.call({"sleep_s": 1.2}))
        blocker.start()
        try:
            time.sleep(0.3)          # the unary call now holds the slot
            shed = _post(port, "/sse", {"stream": True})
            assert int(shed[1]["Retry-After"]) >= 1
            assert json.loads(shed[2])["retry_after_s"] > 0
        finally:
            blocker.join()
        return happy, _contract(*shed)

    want, got = _both(scenario)
    assert got == want
    happy, shed = got
    assert happy == (200, "text/event-stream",
                     ['data: {"i": 0}', 'data: {"i": 1}', 'data: {"i": 2}',
                      "data: [DONE]"])
    assert shed[:4] == (429, "application/json; charset=utf-8", True,
                        ("error", "retry_after_s"))


# --------------------------------------------------------- router resilience


class Flaky:
    def __init__(self, poison_file):
        self.poison_file = poison_file
        self.pid = os.getpid()

    def __call__(self, x=None):
        try:
            poisoned = int(open(self.poison_file).read())
        except (OSError, ValueError):
            poisoned = -1
        if poisoned == self.pid:
            raise RuntimeError("poisoned replica")
        return self.pid


def test_breaker_ejects_probes_and_reenters(clusters, tmp_path):
    """Failure rate opens a replica's breaker (traffic routes around
    it); after cooldown exactly one probation probe goes through —
    failure re-opens, success re-enters the replica."""
    def scenario(art, serve, *_):
        poison_file = tmp_path / f"poison_{art.__name__}"
        dep = serve.deployment(
            Flaky, name="flaky", num_replicas=2,
            breaker_config={"window": 8, "min_outcomes": 3,
                            "failure_rate": 0.5, "cooldown_s": 0.6})
        h = serve.run(dep.bind(str(poison_file)))
        pids = set()
        deadline = time.monotonic() + 20
        while len(pids) < 2 and time.monotonic() < deadline:
            pids.add(h.call())
        assert len(pids) == 2, pids
        victim = sorted(pids)[0]
        survivor = (pids - {victim}).pop()
        poison_file.write_text(str(victim))
        opened = False
        for _ in range(60):
            try:
                h.call()
            except Exception:  # noqa: BLE001 — poisoned replica errors
                pass
            if any(br.state == "open"
                   for br in h._routing.breakers.values()):
                opened = True
                break
        inside = [h.call() == survivor for _ in range(8)]
        time.sleep(0.7)
        try:
            h.call()
            probe = "ok"
        except Exception as e:  # noqa: BLE001 — the replica's error
            probe = str(getattr(e, "cause", e))
        reopened = any(br.state == "open"
                       for br in h._routing.breakers.values())
        poison_file.unlink()
        time.sleep(0.7)
        seen = set()
        deadline = time.monotonic() + 15
        while seen != pids and time.monotonic() < deadline:
            seen.add(h.call())
        return (opened, inside, probe, reopened, seen == pids,
                sorted(br.state for br in h._routing.breakers.values()))

    want, got = _both(scenario)
    assert got == want
    assert got == (True, [True] * 8, "poisoned replica", True, True,
                   ["closed", "closed"])


def test_retry_budget_token_bucket_exhaustion(clusters, tmp_path):
    """Opt-in retries re-pick a different replica, but the token bucket
    bounds amplification."""
    def scenario(art, serve, *_):
        log = tmp_path / f"invocations_{art.__name__}"

        @serve.deployment(name="budget", num_replicas=2,
                          retry_config={"max_attempts": 3,
                                        "budget_fraction": 0.0,
                                        "budget_burst": 1.0},
                          breaker_config={"window": 100,
                                          "min_outcomes": 100})
        class AlwaysFails:
            def __init__(self, log):
                self.log = log

            def __call__(self, x=None):
                with open(self.log, "a") as f:
                    f.write(f"{os.getpid()}\n")
                raise RuntimeError("handler failure")

        h = serve.run(AlwaysFails.bind(str(log)))
        errors = []
        for _ in range(2):
            try:
                h.call()
            except Exception as e:  # noqa: BLE001 — compared below
                errors.append((type(e).__name__,
                               str(getattr(e, "cause", e))))
        invocations = log.read_text().splitlines()
        return (errors, len(invocations), len(set(invocations[:2])),
                h._routing.retry_tokens)

    want, got = _both(scenario)
    assert got == want
    # Call 1: attempt + one budgeted retry on the OTHER replica; call 2:
    # the bucket is empty, exactly one invocation.
    assert got == ([("ActorError", "handler failure")] * 2, 3, 2, 0.0)
