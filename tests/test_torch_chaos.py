"""The port's chaos harness (``util/chaos.py``) against the JAX
package's: the ``ChaosSchedule`` twins of tests/test_resilience.py
(``:57``, ``:76``, ``:90``), run under a ``lockcheck_hunt`` fixture that
fails on any lock-order cycle, as the reference's does (``:34-51``); the
RPC-latency leg of tests/test_serve_overload.py (``:102-128``) against
the port's ``_ChaosInjector``, the live leg in a cluster of each package
under the same schedule; and ``preemption_notice`` raising, naming
ROADMAP item 9 (the port has no preemption watch for a notice to reach).
The reference's training and preemption scenarios wait for items 7 and
9."""

import importlib
import os
import statistics
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu._lint import lockcheck as jlockcheck
from ant_ray_tpu._private.config import Config as JConfig
from ant_ray_tpu._private.protocol import _ChaosInjector as JInjector
from ant_ray_tpu.util.chaos import ChaosSchedule as JSchedule
from ant_ray_tpu_torch._lint import lockcheck
from ant_ray_tpu_torch._private.config import Config
from ant_ray_tpu_torch._private.protocol import _ChaosInjector
from ant_ray_tpu_torch.util.chaos import ChaosSchedule
from ant_ray_tpu_torch.util.chaos import chaos_schedule  # noqa: F401 — the fixture


@pytest.fixture(autouse=True)
def lockcheck_hunt(monkeypatch):
    """Every test here runs with ART_LOCKCHECK=1: spawned daemons inherit
    the env var, init re-reads it in-process, so each chaos run doubles
    as a deadlock hunt over the runtime's planes.  Teardown asserts the
    hunt came back empty in this process (a daemon's detection is in
    its log, which the live leg reads)."""
    monkeypatch.setenv("ART_LOCKCHECK", "1")
    for module in (jlockcheck, lockcheck):
        module.reset()          # re-evaluate enabled() from the env
    yield
    cycles = [r for module in (jlockcheck, lockcheck)
              for r in module.reports() if r["kind"] == "cycle"]
    monkeypatch.delenv("ART_LOCKCHECK")
    for module in (jlockcheck, lockcheck):
        module.reset()
    assert not cycles, f"lockcheck found lock-order inversion(s): {cycles}"


# --------------------------------------------- tests/test_resilience.py :57-:90

def test_chaos_schedule_unifies_knobs(chaos_schedule):
    def knobs(schedule):
        schedule.rpc_failure("Heartbeat", 0.2)
        schedule.rpc_failure("LeaseWorker", 0.1)
        schedule.chunk_serve_delay(0.01)
        schedule.chunk_truncate(1024)
        return schedule.system_config()

    want = knobs(JSchedule(seed=0))
    cfg = knobs(chaos_schedule)
    assert cfg == want
    assert cfg["testing_rpc_failure"] == \
        "seed:0,Heartbeat:0.2,LeaseWorker:0.1"
    assert cfg["testing_chunk_serve_delay_s"] == 0.01
    assert cfg["testing_chunk_truncate"] == 1024
    # The JAX package's notice knob has no reader in the port (item 9).
    with pytest.raises(NotImplementedError, match="item 9"):
        chaos_schedule.preemption_notice()
    assert "testing_preemption_notice" not in chaos_schedule.system_config()
    # Every knob the schedule writes must be a real config flag, of both
    # packages.
    for key in cfg:
        assert hasattr(Config(), key), f"unknown config flag {key}"
        assert hasattr(JConfig(), key), key


def test_chaos_schedule_fire_order_and_determinism(chaos_schedule):
    def scenario(schedule):
        fired = []
        schedule.at_step(5, lambda: fired.append("late"), "late")
        schedule.at_step(2, lambda: fired.append("early"), "early")
        schedule.at_step(2, lambda: fired.append("early2"), "early2")
        out = [schedule.fire(1), schedule.pending]
        # Catch-up fire runs everything due, in (step, registration)
        # order, exactly once.
        out += [schedule.fire(6), list(fired), schedule.fire(7),
                schedule.pending]
        return out

    want, got = scenario(JSchedule(seed=0)), scenario(chaos_schedule)
    assert want == got == [[], ["early", "early2", "late"],
                           ["early", "early2", "late"],
                           ["early", "early2", "late"], [], []]


def test_chaos_rpc_failure_spec_is_seeded_deterministic():
    def rolls(schedule_cls, injector_cls, seed):
        spec = (schedule_cls(seed=seed).rpc_failure("Ping", 0.5)
                .system_config()["testing_rpc_failure"])
        # The spec itself carries the seed: injectors built from it
        # alone (as every daemon does, via _system_config) replay
        # identically.
        injectors = [injector_cls(spec) for _ in range(2)]
        return spec, [[i.should_fail("Ping") for _ in range(64)]
                      for i in injectors]

    spec, (a, b) = rolls(ChaosSchedule, _ChaosInjector, 3)
    assert spec.startswith("seed:3,")
    assert a == b                   # same seed, same schedule
    assert any(a) and not all(a)
    # A different schedule seed produces a DIFFERENT fault sequence.
    assert rolls(ChaosSchedule, _ChaosInjector, 4)[1][0] != a
    # ...and the port's sequence is the JAX package's, seed for seed.
    assert rolls(JSchedule, JInjector, 3) == (spec, [a, b])


def test_chaos_schedule_kill_leader_resolves_at_fire_time(chaos_schedule):
    """``kill_leader`` asks the cluster for its leader when the step
    fires, not when it is scheduled, and records the killed address."""
    class FakeCluster:
        def __init__(self):
            self.leader = "a:1"

        def kill_gcs_leader(self):
            killed, self.leader = self.leader, "b:2"
            return killed

    def scenario(schedule):
        cluster = FakeCluster()
        schedule.kill_leader(3, cluster)
        cluster.leader = "c:3"            # moved after scheduling
        return schedule.fire(2), schedule.fire(3), schedule.killed_leaders

    want, got = scenario(JSchedule(seed=0)), scenario(chaos_schedule)
    assert want == got == ([], ["kill_leader"], ["c:3"])


# ---------------------------------- tests/test_serve_overload.py :102-:128

def test_chaos_rpc_latency_spec_parses(chaos_schedule):
    """testing_rpc_latency_s rides the same _system_config channel as
    the failure knob and parses per-method in the port's injector."""
    chaos_schedule.rpc_latency("PushTask", 0.05)
    chaos_schedule.rpc_latency("Ping", 0.01)
    cfg = chaos_schedule.system_config()
    assert cfg == (JSchedule(seed=0).rpc_latency("PushTask", 0.05)
                   .rpc_latency("Ping", 0.01).system_config())
    assert cfg["testing_rpc_latency_s"] == "Ping:0.01,PushTask:0.05"
    assert hasattr(Config(), "testing_rpc_latency_s")

    for injector in (_ChaosInjector("", latency_spec=cfg[
            "testing_rpc_latency_s"]), JInjector("", latency_spec=cfg[
                "testing_rpc_latency_s"])):
        assert injector.delay_for("PushTask") == 0.05
        assert injector.delay_for("Ping") == 0.01
        assert injector.delay_for("ReadChunk") == 0.0


def _latency_run(art, schedule):
    """A cluster of ``art`` under ``schedule``'s knobs: five actor calls'
    values and round trips; no process's log holds a lockcheck cycle
    report."""
    art.init(num_cpus=2, num_tpus=0, _system_config=schedule.system_config())
    try:
        @art.remote
        class Echo:
            def ping(self, x):
                return x

        echo = Echo.remote()
        assert art.get(echo.ping.remote(-1), timeout=60) == -1   # warm
        times, values = [], []
        for i in range(5):
            t0 = time.perf_counter()
            values.append(art.get(echo.ping.remote(i), timeout=60))
            times.append(time.perf_counter() - t0)
        worker = importlib.import_module(art.__name__ + "._private.worker")
        logs = os.path.join(worker.global_worker.runtime.session_dir, "logs")
        inverted = []
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name), errors="replace") as f:
                if "lock-order inversion" in f.read():
                    inverted.append(name)
        assert inverted == [], f"cycle reports in {inverted}"
        return values, times
    finally:
        art.shutdown()


def test_rpc_latency_injection_is_live():
    """The live leg: a cluster started with the seeded schedule's
    ``rpc_latency("PushTask", 0.005)`` (the knobs reach every process
    through the env channel) really injects — no actor call round-trips
    faster than the configured latency — in each package, one cluster
    at a time (both read the same ``ART_*`` variables)."""
    want, want_s = _latency_run(jart, JSchedule(seed=7).rpc_latency(
        "PushTask", 0.005))
    got, got_s = _latency_run(tart, ChaosSchedule(seed=7).rpc_latency(
        "PushTask", 0.005))
    assert want == got == list(range(5))
    assert min(want_s) >= 0.005 and min(got_s) >= 0.005, (want_s, got_s)
    assert statistics.median(got_s) >= 0.005


def test_preemption_notice_raises_naming_item_9(chaos_schedule):
    """The port's daemons have no preemption watch, so the schedule
    writes no notice that nothing would read."""
    for call in (chaos_schedule.preemption_notice,
                 chaos_schedule.trigger_preemption):
        with pytest.raises(NotImplementedError,
                           match="preemption watch.*ROADMAP queue A item 9"):
            call()
    assert chaos_schedule.system_config() == {}
    assert not hasattr(Config(), "testing_preemption_notice")
