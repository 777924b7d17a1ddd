"""The port's Serve overload plane under injected RPC latency, against the
JAX package's: tests/test_serve_overload.py runs its whole module in a
cluster started with ``ChaosSchedule(seed=7).rpc_latency("PushTask",
0.005)`` (``:28-40``), every actor call riding a 5 ms link.  Here the
scenarios of tests/test_torch_serve_overload.py that need a cluster run
in such a cluster of each package, one package after the other (the
schedule's knobs reach the processes as ``ART_*`` variables, which both
packages read), in the reference's order; each test then holds the two
outcomes equal and keeps the reference's assertions.  The injection is
checked live (no actor call faster than the latency).  The reference's
two ``slow`` tests, the poll strikes that eject a wedged (SIGSTOPped)
replica (``:525``) and the overload soak (``:703``), are twinned with
the same mark, each in a chaos cluster of its own per package."""

import importlib
import os
import signal
import threading
import time

import pytest

import test_torch_serve_overload as overload
from runtime_twins import IDS, error, mod

PACKAGES = overload.PACKAGES


def _schedule(art):
    return mod(art, "util.chaos").ChaosSchedule(seed=7).rpc_latency(
        "PushTask", 0.005)


class _ChaosCluster:
    """``init(num_cpus=4)`` of the package ``pkg`` under the seeded
    latency schedule; Serve and the cluster shut down on exit."""

    def __init__(self, pkg):
        self.art, self.serve = pkg[0], pkg[1]

    def __enter__(self):
        self.art.init(num_cpus=4, num_tpus=0,
                      _system_config=_schedule(self.art).system_config())
        return self

    def __exit__(self, *exc):
        try:
            self.serve.shutdown()
        finally:
            self.art.shutdown()


def latency_live(pkg, env):
    """No actor call round-trips faster than the PushTask latency."""
    cap = env["cap"][0]
    cap.call({"sleep_s": 0})                    # warm the route
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cap.call({"sleep_s": 0})
        times.append(time.perf_counter() - t0)
    assert min(times) >= 0.005, times
    return len(times)


def _grpc_contract(pkg, env):
    if importlib.util.find_spec("grpc") is None:
        return "no grpc"
    return overload.grpc_contract(pkg, env)


# The reference's order of the module's cluster tests, but its two slow
# ones.
SCENARIOS = (overload.admission, latency_live, overload.deadline_sheds,
             overload.cancel_reaps, overload.batch_deadline,
             overload.batch_flush, overload.http_contract, _grpc_contract,
             overload.http_stream_shed, overload.breaker,
             overload.retry_budget)


def _run(fn, pkg, env):
    try:
        return ("ok", fn(pkg, env))
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", error(e))


@pytest.fixture(scope="module")
def chaos_outcomes(tmp_path_factory):
    """{package id: {scenario: outcome}} from each package's chaos
    cluster in turn."""
    outs = {}
    for name in IDS:
        pkg = PACKAGES[name]
        with _ChaosCluster(pkg) as cluster:
            dep = cluster.serve.deployment(
                overload.Cap, name="cap", route_prefix="/cap",
                max_ongoing_requests=1, max_queued_requests=1)
            handle = cluster.serve.run(dep.bind(), port=0, grpc_port=0)
            env = {"cap": (handle, cluster.serve.api.run.last_http_port,
                           cluster.serve.run.last_grpc_port),
                   "tmp": tmp_path_factory.mktemp(f"chaos_{name}")}
            outs[name] = {fn.__name__: _run(fn, pkg, env)
                          for fn in SCENARIOS}
    return outs


def _equal(outcomes, scenario):
    want, got = (outcomes[name][scenario.__name__] for name in IDS)
    assert want[0] == "ok", want
    assert got == want
    return got[1]


def test_admission_sheds_at_capacity_under_latency(chaos_outcomes):
    got = _equal(chaos_outcomes, overload.admission)
    assert got[1] == {"replica at capacity (<n> running, <n> queued)"}


def test_rpc_latency_injection_is_live(chaos_outcomes):
    assert _equal(chaos_outcomes, latency_live) == 5


def test_deadline_sheds_queued_work_never_executed_under_latency(
        chaos_outcomes):
    occupier, results, executed = _equal(chaos_outcomes,
                                         overload.deadline_sheds)
    assert occupier == [("deadline", "dlshed: no reply within <n>s "
                         "(attempt <n>)")]
    assert results == [("deadline", 1), ("deadline", 2), ("deadline", 3)]
    assert executed == [0]


def test_cancel_reaps_queued_actor_task_under_latency(chaos_outcomes):
    assert _equal(chaos_outcomes, overload.cancel_reaps) == (True, 0, [0])


def test_batch_deadline_pulls_flush_forward_under_latency(chaos_outcomes):
    assert _equal(chaos_outcomes, overload.batch_deadline) == 42


def test_batch_flush_is_event_driven_under_latency(chaos_outcomes):
    assert _equal(chaos_outcomes, overload.batch_flush) == [1, 2, 3, 4]


def test_http_contract_429_retry_after_and_504_under_latency(
        chaos_outcomes):
    mixed, deadline, malformed = _equal(chaos_outcomes,
                                        overload.http_contract)
    assert (200, "application/json; charset=utf-8", False, ("result",),
            None) in mixed
    assert (429, "application/json; charset=utf-8", True,
            ("error", "retry_after_s"),
            "replica at capacity (<n> running, <n> queued)") in mixed
    assert deadline == (504, "application/json; charset=utf-8", False,
                        ("error",), "cap: no reply within <n>s "
                        "(attempt <n>)")
    assert malformed[0] == 400


def test_grpc_contract_resource_exhausted_and_deadline_under_latency(
        chaos_outcomes):
    pytest.importorskip("grpc")
    got = _equal(chaos_outcomes, _grpc_contract)
    assert got[0] == {'{"result": "done"}'}
    assert ("RESOURCE_EXHAUSTED",
            "replica at capacity (<n> running, <n> queued)") in got[1]
    assert got[3:5] == ("err", "DEADLINE_EXCEEDED")


def test_http_stream_shed_surfaces_429_under_latency(chaos_outcomes):
    happy, shed = _equal(chaos_outcomes, overload.http_stream_shed)
    assert happy == (200, "text/event-stream",
                     ['data: {"i": 0}', 'data: {"i": 1}', 'data: {"i": 2}',
                      "data: [DONE]"])
    assert shed[:4] == (429, "application/json; charset=utf-8", True,
                        ("error", "retry_after_s"))


def test_breaker_ejects_probes_and_reenters_under_latency(chaos_outcomes):
    assert _equal(chaos_outcomes, overload.breaker) == (
        True, [True] * 8, "poisoned replica", True, True,
        ["closed", "closed"])


def test_retry_budget_token_bucket_exhaustion_under_latency(
        chaos_outcomes):
    assert _equal(chaos_outcomes, overload.retry_budget) == (
        [("ActorError", "handler failure")] * 2, 3, 2, 0.0)


# --------------------------------------------------------------- slow twins


def _in_chaos_clusters(scenario, tmp_path):
    """``scenario(pkg, env)`` in a chaos cluster of each package in
    turn; both outcomes, the JAX package's first."""
    outs = []
    for name in IDS:
        with _ChaosCluster(PACKAGES[name]):
            outs.append(scenario(PACKAGES[name], {"tmp": tmp_path,
                                                  "cap": None}))
    return outs


class Wedge:
    def __call__(self, x=None):
        return os.getpid()


def poll_strikes(pkg, env):
    """A wedged replica (SIGSTOP: answers nothing, closes nothing) is
    marked suspect by repeated poll timeouts, every handle's breaker for
    it opens (no traffic reaches it), and a successful poll after it
    resumes lets it back in."""
    _art, serve, *_ = pkg
    dep = serve.deployment(Wedge, name="wedge", num_replicas=2,
                           max_ongoing_requests=4,
                           breaker_config={"cooldown_s": 0.5})
    h = serve.run(dep.bind())
    pids = set()
    deadline = time.monotonic() + 20
    while len(pids) < 2 and time.monotonic() < deadline:
        pids.add(h.call(timeout_s=5))
    assert len(pids) == 2, pids
    victim = sorted(pids)[0]
    survivor = (pids - {victim}).pop()
    os.kill(victim, signal.SIGSTOP)
    try:
        deadline = time.monotonic() + 25
        while not h._routing.suspect and time.monotonic() < deadline:
            time.sleep(0.2)
        assert h._routing.suspect, \
            "poll strikes never marked the wedged replica suspect"
        # Ejected: no request reaches the wedge or blocks on it.
        routed = [h.call(timeout_s=2.0) == survivor for _ in range(8)]
        assert all(routed)
        opened = any(br.state == "open"
                     for br in h._routing.breakers.values())
        assert opened
    finally:
        os.kill(victim, signal.SIGCONT)
    deadline = time.monotonic() + 20
    while h._routing.suspect and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not h._routing.suspect, "suspect mark never cleared"
    seen = set()
    deadline = time.monotonic() + 15
    while seen != pids and time.monotonic() < deadline:
        seen.add(h.call(timeout_s=5))
    assert seen == pids, (seen, pids)
    return routed, opened, seen == pids


@pytest.mark.slow
def test_ongoing_poll_strikes_eject_wedged_replica(tmp_path):
    want, got = _in_chaos_clusters(poll_strikes, tmp_path)
    assert got == want == ([True] * 8, True, True)


class Soak:
    def __call__(self, x=None):
        time.sleep(0.1)
        return os.getpid()


def soak(pkg, env):
    """Offered load >= 4x capacity under the latency: admitted requests
    keep a p99 within the deadline, the excess sheds with the typed
    contract, and no replica crashes."""
    _art, serve, backpressure, deadline_error, _c = pkg
    dep = serve.deployment(Soak, name="soak", num_replicas=2,
                           max_ongoing_requests=1, max_queued_requests=1,
                           request_timeout_s=1.0)
    h = serve.run(dep.bind())
    pids_before = set()
    deadline = time.monotonic() + 20
    while len(pids_before) < 2 and time.monotonic() < deadline:
        pids_before.add(h.call())
    assert len(pids_before) == 2
    # Capacity ~= 2 slots / 0.1 s = 20 rps (+ 2 queue seats); 16
    # closed-loop clients whose sheds return in milliseconds offer
    # several hundred rps.
    stop_at = time.monotonic() + 6.0
    records, errors = [], []
    lock = threading.Lock()

    def client():
        try:
            while time.monotonic() < stop_at:
                t0 = time.perf_counter()
                try:
                    h.call()
                    tag = "ok"
                except backpressure:
                    tag = "shed"
                except deadline_error:
                    tag = "deadline"
                with lock:
                    records.append((tag, time.perf_counter() - t0))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, f"non-contract failures under overload: {errors!r}"
    oks = sorted(lat for tag, lat in records if tag == "ok")
    sheds = [1 for tag, _ in records if tag != "ok"]
    assert len(oks) >= 50, f"too few admitted: {len(oks)}"
    assert sheds, "offered >> capacity yet nothing was shed"
    assert len(records) >= 4 * len(oks) or len(sheds) >= len(oks), \
        (len(records), len(oks))
    p99 = oks[int(0.99 * (len(oks) - 1))]
    assert p99 <= 1.0 + 0.3, f"admitted p99 {p99:.3f}s exceeds deadline"
    time.sleep(0.3)
    pids_after = {h.call() for _ in range(12)}
    assert pids_after == pids_before, (pids_before, pids_after)
    return (not errors, len(oks) >= 50, bool(sheds), p99 <= 1.3,
            pids_after == pids_before)


@pytest.mark.slow
def test_overload_soak_bounded_p99_and_zero_crashes(tmp_path):
    want, got = _in_chaos_clusters(soak, tmp_path)
    assert got == want == (True, True, True, True, True)
