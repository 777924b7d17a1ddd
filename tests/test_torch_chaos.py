"""The port's chaos harness (``util/chaos.py``) against the JAX
package's: the ``ChaosSchedule`` twins of tests/test_resilience.py
(``:57``, ``:76``, ``:90``), run under a ``lockcheck_hunt`` fixture that
fails on any lock-order cycle, as the reference's does (``:34-51``); the
RPC-latency leg of tests/test_serve_overload.py (``:102-128``) against
the port's ``_ChaosInjector``, the live leg in a cluster of each package
under the same schedule; the preemption notice file of both packages,
and ``:109`` (the notice drains the daemon) in a cluster of each.
The training scenarios of tests/test_resilience.py run on the port's
``TorchTrainer`` with the reference's assertions: ``:145`` (a drain
notice mid-fit migrates the gang, zero steps lost or repeated),
``:337`` (a crash restores from the in-cluster replica), ``:454`` (the
GCS restarts mid-fit), ``:599`` (the GCS leader killed mid-fit while
Serve answers) and ``:228`` (a whole slice killed mid-fit: the two-slice
gang restarts from its checkpoint, zero steps lost)."""

import importlib
import os
import shutil
import statistics
import threading
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu._lint import lockcheck as jlockcheck
from ant_ray_tpu._private.config import Config as JConfig
from ant_ray_tpu._private.protocol import _ChaosInjector as JInjector
from ant_ray_tpu.util.chaos import ChaosSchedule as JSchedule
from ant_ray_tpu_torch import serve, train
from ant_ray_tpu_torch._lint import lockcheck
from ant_ray_tpu_torch._private.config import Config
from ant_ray_tpu_torch._private.protocol import _ChaosInjector
from ant_ray_tpu_torch.cluster_utils import Cluster
from ant_ray_tpu_torch.train import (
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
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
    # The notice knob: a path of the schedule's own, in both packages.
    jschedule = JSchedule(seed=0)
    try:
        jnotice = jschedule.preemption_notice()
        notice = chaos_schedule.preemption_notice()
        cfg = chaos_schedule.system_config()
        assert cfg["testing_preemption_notice"] == notice
        assert jschedule.system_config()["testing_preemption_notice"] == \
            jnotice
        assert os.path.dirname(notice) == os.path.dirname(jnotice)
        assert not os.path.exists(notice)     # registered, not armed
    finally:
        jschedule.cleanup()
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
    """Once a pin on the unported notice; now the notice file of both
    packages: arming writes ``"<deadline_s> <reason>"`` atomically, both
    packages' readers parse it the same, and cleanup removes it."""
    from ant_ray_tpu._private.accelerators import tpu as jtpu
    from ant_ray_tpu._private.config import set_global_config as jset
    from ant_ray_tpu_torch._private.accelerators import gpu
    from ant_ray_tpu_torch._private.config import set_global_config

    with pytest.raises(RuntimeError, match="preemption_notice"):
        chaos_schedule.trigger_preemption()
    path = chaos_schedule.preemption_notice()
    answers = []
    for setter, cfg_cls, module in ((jset, JConfig, jtpu),
                                    (set_global_config, Config, gpu)):
        setter(cfg_cls().apply_dict({"testing_preemption_notice": path}))
    try:
        for module in (jtpu, gpu):
            assert module.maintenance_watch_possible()
            answers.append(module.maintenance_notice())
        chaos_schedule.trigger_preemption(deadline_s=17.5,
                                          reason="maintenance window")
        for module in (jtpu, gpu):
            answers.append(module.maintenance_notice())
    finally:
        jset(JConfig())
        set_global_config(Config())
    assert answers == [None, None, ("maintenance window", 17.5),
                       ("maintenance window", 17.5)]
    with open(path) as f:
        assert f.read() == "17.5 maintenance window\n"
    chaos_schedule.cleanup()
    assert not os.path.exists(path)


# ------------------------------------ tests/test_resilience.py :109, :228

def _drain_on_notice(art, schedule):
    """The reference's scenario in ``art``'s cluster: the notice file
    fires the daemon's watch, which drains the node through the GCS."""
    utils = importlib.import_module(art.__name__ + ".cluster_utils")
    schedule.preemption_notice()
    cluster = utils.Cluster(head_node_args={
        "num_cpus": 1,
        "_system_config": {**schedule.system_config(),
                           "preemption_poll_interval_s": 0.1}})
    cluster.connect()
    try:
        before = any(n["Draining"] for n in art.nodes())
        schedule.trigger_preemption(deadline_s=17.5,
                                    reason="maintenance window")
        deadline = time.monotonic() + 30
        node = None
        while time.monotonic() < deadline:
            node = next(n for n in art.nodes())
            if node["Draining"]:
                break
            time.sleep(0.1)
        return (before, node["Draining"],
                "maintenance window" in node["DrainReason"],
                node["DrainReason"], node["DrainDeadline"] > 0,
                node["Alive"])
    finally:
        art.shutdown()
        cluster.shutdown()
        schedule.cleanup()


def test_preemption_notice_file_drains_daemon():
    """The testing_preemption_notice file (the maintenance-event
    stand-in) fires each package's daemon watch, which self-drains via
    the GCS DrainNode RPC; the outcomes are equal."""
    want = _drain_on_notice(jart, JSchedule(seed=0))
    got = _drain_on_notice(tart, ChaosSchedule(seed=0))
    assert got == want
    before, draining, has_reason, reason, has_deadline, alive = got
    assert not before and draining and has_reason and has_deadline and alive
    assert reason == "preemption notice: maintenance window"


# ------------------------------------- tests/test_resilience.py, training

def _fit_in_thread(trainer):
    box = {}
    t = threading.Thread(target=lambda: box.update(result=trainer.fit()),
                         daemon=True)
    t.start()
    return t, box


def test_drain_notice_zero_step_loss(tmp_path):
    """test_resilience.py :145 — a drain notice mid-fit migrates the
    gang off the draining node with ZERO steps lost or re-executed,
    without touching the failure budget (max_failures=0)."""
    steplog = tmp_path / "steps.log"
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"gang": 1})
    cluster.add_node(num_cpus=2, resources={"gang": 1})
    cluster.connect()
    try:
        def loop(config):
            ctx = train.get_context()
            start = 0
            if ctx.latest_checkpoint is not None:
                start = int(ctx.latest_checkpoint
                            .to_pytree()["step"]) + 1
            for step in range(start, 8):
                with open(config["steplog"], "a") as f:
                    f.write(f"{step} "
                            f"{os.environ.get('ART_NODE_ID', '')}\n")
                time.sleep(0.3)
                train.report({"step": step}, checkpoint={"step": step})

        t, box = _fit_in_thread(TorchTrainer(
            loop, train_loop_config={"steplog": str(steplog)},
            scaling_config=ScalingConfig(
                num_workers=1,
                resources_per_worker={"CPU": 1.0, "gang": 0.5}),
            run_config=RunConfig(
                name="drain-zero-loss",
                storage_path=str(tmp_path / "store"),
                failure_config=FailureConfig(max_failures=0))))
        deadline = time.monotonic() + 90
        node_hex = None
        while time.monotonic() < deadline:
            if steplog.exists():
                lines = steplog.read_text().splitlines()
                if len(lines) >= 3:
                    node_hex = lines[-1].split()[1]
                    break
            time.sleep(0.2)
        assert node_hex, "gang never started"
        target = next(n for n in tart.nodes() if n["NodeID"] == node_hex)
        cluster.drain_node(target["Address"], reason="maintenance",
                           deadline_s=60)
        t.join(timeout=120)
        assert not t.is_alive(), "fit never finished after drain"
        result = box["result"]
        assert result.error is None
        rows = [line.split() for line in steplog.read_text().splitlines()]
        steps = [int(r[0]) for r in rows]
        assert sorted(steps) == list(range(8))
        assert len(steps) == len(set(steps))
        assert len({r[1] for r in rows}) == 2, "gang did not migrate"
        assert result.metrics["step"] == 7
        assert next(n for n in tart.nodes()
                    if n["NodeID"] == node_hex)["Draining"]
    finally:
        tart.shutdown()
        cluster.shutdown()


def test_fault_slice_gang_restarts_zero_step_loss(tmp_path, chaos_schedule):
    """test_resilience.py :228 — a whole-slice failure mid-step (chaos
    ``fault_slice``: every daemon of one slice SIGKILLed as a unit)
    kills that slice's rank; the two-slice gang restarts from the last
    checkpoint on a replacement node with zero steps LOST."""
    steplog = tmp_path / "steps.log"
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"gang": 1},
                     labels={"art-slice-id": "0"})
    cluster.add_node(num_cpus=2, resources={"gang": 1},
                     labels={"art-slice-id": "1"})
    cluster.connect()
    # Slice 1 dies as a unit once the gang demonstrably runs; a
    # replacement node (slice 2) joins in the same fire.
    chaos_schedule.fault_slice(3, "1", cluster)
    chaos_schedule.at_step(
        3, lambda: cluster.add_node(num_cpus=2, resources={"gang": 1},
                                    labels={"art-slice-id": "2"}),
        label="replacement_node")
    try:
        def loop(config):
            import torch

            ctx = train.get_context()
            start = 0
            if ctx.latest_checkpoint is not None:
                start = int(ctx.latest_checkpoint
                            .to_pytree()["step"]) + 1
            # num_slices=2 fed the context the 2-slice rank partition.
            assert ctx.slice_topology is not None
            assert ctx.slice_topology.num_slices == 2
            for step in range(start, 8):
                if ctx.world_rank == 0:
                    with open(config["steplog"], "a") as f:
                        f.write(f"{step} "
                                f"{os.environ.get('ART_NODE_ID', '')} "
                                f"{ctx.attempt}\n")
                time.sleep(0.25)
                # The gang's own hierarchical allreduce is the
                # lock-step: once slice 1 dies, the survivor blocks here.
                grads = train.sync_gradients(
                    {"g": torch.full((8,), float(step))})
                assert float(grads["g"][0]) == float(step)
                train.report({"step": step}, checkpoint={"step": step})

        t, box = _fit_in_thread(TorchTrainer(
            loop, train_loop_config={"steplog": str(steplog)},
            scaling_config=ScalingConfig(
                num_workers=2, num_slices=2,
                resources_per_worker={"CPU": 1.0, "gang": 1.0}),
            run_config=RunConfig(
                name="fault-slice-zero-loss",
                storage_path=str(tmp_path / "store"),
                failure_config=FailureConfig(
                    max_failures=1, group_restart_backoff_s=0.2))))
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if steplog.exists() and \
                    len(steplog.read_text().splitlines()) >= 3:
                break
            time.sleep(0.2)
        assert steplog.exists(), "gang never started"
        fired = chaos_schedule.fire(3)
        assert "fault_slice:1" in fired
        assert len(chaos_schedule.killed_slices["1"]) == 1
        t.join(timeout=150)
        assert not t.is_alive(), "fit never finished after slice fault"
        result = box["result"]
        assert result.error is None
        rows = [line.split() for line in steplog.read_text().splitlines()]
        steps = [int(r[0]) for r in rows]
        # Zero steps LOST: every step reached the log (the step in
        # flight may run twice) and the run resumed from the checkpoint.
        assert sorted(set(steps)) == list(range(8))
        assert max(int(r[2]) for r in rows) == 1, "gang never restarted"
        restarted = [r for r in rows if int(r[2]) == 1]
        assert restarted and min(int(r[0]) for r in restarted) > 0, \
            "restart re-ran from step 0 — checkpoint resume failed"
        assert result.metrics["step"] == 7
    finally:
        tart.shutdown()
        cluster.shutdown()


def test_worker_kill_replica_restore(tmp_path):
    """test_resilience.py :337 — a worker crash recovers from the
    in-cluster checkpoint replica when the storage copy is gone."""
    tart.init(num_cpus=2)
    try:
        def loop(config):
            ctx = train.get_context()
            start = 0
            restored_from = ""
            if ctx.latest_checkpoint is not None:
                restored_from = ctx.latest_checkpoint.as_directory()
                start = int(ctx.latest_checkpoint.to_pytree()["step"]) + 1
            for step in range(start, 6):
                train.report({"step": step,
                              "restored_from": restored_from},
                             checkpoint={"step": step})
                if step == 3 and ctx.attempt == 0:
                    token = os.path.join(ctx.storage_path,
                                         "checkpoint_000003", ".run_token")
                    deadline = time.monotonic() + 60
                    while time.monotonic() < deadline and \
                            not os.path.exists(token):
                        time.sleep(0.05)
                    assert os.path.exists(token), "save never registered"
                    import glob as _glob

                    for d in _glob.glob(os.path.join(ctx.storage_path,
                                                     "checkpoint_*")):
                        shutil.rmtree(d, ignore_errors=True)
                    raise RuntimeError("chaos: induced worker crash")

        result = TorchTrainer(
            loop, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                name="replica-restore", storage_path=str(tmp_path),
                failure_config=FailureConfig(
                    max_failures=1, group_restart_backoff_s=0.4))).fit()
        assert result.error is None
        assert result.metrics["step"] == 5
        assert "art_ckpt_replicas" in result.metrics["restored_from"]
    finally:
        tart.shutdown()


def test_gcs_restart_during_fit(tmp_path):
    """test_resilience.py :454 — the head dies and restarts DURING an
    active fit: reports keep flowing through the outage, the checkpoint
    reported during it is adopted, and the fit completes."""
    gate = tmp_path / "resume.flag"
    steplog = tmp_path / "steps.log"
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        def loop(config):
            ctx = train.get_context()
            assert ctx.latest_checkpoint is None
            for step in range(6):
                if step == 4:
                    deadline = time.monotonic() + 90
                    while time.monotonic() < deadline and \
                            not os.path.exists(config["gate"]):
                        time.sleep(0.1)
                    assert os.path.exists(config["gate"])
                train.report({"step": step}, checkpoint={"step": step})
                with open(config["steplog"], "a") as f:
                    f.write(f"{step}\n")

        t, box = _fit_in_thread(TorchTrainer(
            loop, train_loop_config={"gate": str(gate),
                                     "steplog": str(steplog)},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                name="gcs-bounce", storage_path=str(tmp_path / "store"),
                failure_config=FailureConfig(max_failures=0))))
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if steplog.exists() and \
                    len(steplog.read_text().splitlines()) >= 2:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("fit never reached step 2")
        cluster.kill_gcs()
        time.sleep(1.0)
        cluster.restart_gcs()
        gate.write_text("go")
        t.join(timeout=120)
        assert not t.is_alive(), "fit wedged across the GCS restart"
        result = box["result"]
        assert result.error is None
        assert result.metrics["step"] == 5
        assert result.checkpoint is not None
        assert int(result.checkpoint.to_pytree()["step"]) == 5
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if sum(1 for n in tart.nodes() if n["Alive"]) == 2:
                break
            time.sleep(0.2)
        assert sum(1 for n in tart.nodes() if n["Alive"]) == 2
    finally:
        tart.shutdown()
        cluster.shutdown()


def test_chaos_soak_leader_kill_mid_train_and_serve(tmp_path):
    """test_resilience.py :599 — the GCS leader is killed (logical-step
    scheduled) while a fit reports steps and a Serve deployment takes
    traffic, under a lossy heartbeat channel: the fit completes with
    zero step loss and re-execution, serving never errors."""
    chaos = ChaosSchedule(seed=13)
    chaos.rpc_failure("Heartbeat", 0.05)
    steplog = tmp_path / "steps.log"
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "gcs_standbys": 1,
        "_system_config": chaos.system_config()})
    cluster.add_node(num_cpus=2)
    cluster.connect()
    chaos.kill_leader(3, cluster)
    try:
        @serve.deployment
        def echo(req):
            return {"ok": req}

        handle = serve.run(echo.bind())
        assert tart.get(handle.remote(0), timeout=60) == {"ok": 0}

        def loop(config):
            ctx = train.get_context()
            assert ctx.latest_checkpoint is None
            for step in range(8):
                with open(config["steplog"], "a") as f:
                    f.write(f"{ctx.attempt} {step}\n")
                time.sleep(0.25)
                train.report({"step": step}, checkpoint={"step": step})

        fit_thread, box = _fit_in_thread(TorchTrainer(
            loop, train_loop_config={"steplog": str(steplog)},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                name="ha-soak", storage_path=str(tmp_path / "store"),
                failure_config=FailureConfig(max_failures=0))))
        served = {"ok": 0, "err": 0}
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and fit_thread.is_alive():
            lines = (steplog.read_text().splitlines()
                     if steplog.exists() else [])
            if lines:
                chaos.fire(int(lines[-1].split()[1]))
            try:
                reply = tart.get(handle.remote(len(lines)), timeout=30)
                assert reply == {"ok": len(lines)}
                served["ok"] += 1
            except Exception:  # noqa: BLE001 — counted, asserted below
                served["err"] += 1
            time.sleep(0.1)
        fit_thread.join(timeout=60)
        assert not fit_thread.is_alive(), "fit wedged across failover"
        assert chaos.killed_leaders, "kill_leader never fired"
        result = box["result"]
        assert result.error is None
        assert result.metrics["step"] == 7
        rows = [(int(a), int(s))
                for a, s in (line.split() for line in
                             steplog.read_text().splitlines())]
        assert sorted(s for _a, s in rows) == list(range(8))
        assert {a for a, _s in rows} == {0}
        assert len({s for _a, s in rows}) / len(rows) >= 0.90
        assert served["ok"] >= 5
        assert served["err"] == 0, served
        from ant_ray_tpu_torch._private.worker import global_worker

        summary = global_worker.runtime._gcs.call(
            "SummarizeTasks", {}, retries=3)
        assert summary["total_tasks"] > 0
    finally:
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001
            pass
        tart.shutdown()
        cluster.shutdown()
