"""The port's lockcheck (``_lint/lockcheck.py``: instrumented locks, the
per-thread held stack, the acquisition-order graph, cycle and long-hold
reports through the logger and the flight recorder) against the JAX
package's.  Each lockcheck scenario of tests/test_lint.py (``:581-745``
but ``:724``, the linter's CLI) runs through both packages' modules, and
the outcomes must be equal: the lock types, the reports (their kinds,
names and edge counts), the recorded spans.  Also: the ``LOCKCHECK:``
log line, ``edges()``, and a port cluster started with
``_system_config={"lockcheck": True}`` whose every process instruments
its locks and reports no cycle."""

import importlib
import logging
import os
import threading
import time


PACKAGES = ("ant_ray_tpu", "ant_ray_tpu_torch")


def _mods(pkg):
    return (importlib.import_module(f"{pkg}._lint.lockcheck"),
            importlib.import_module(f"{pkg}._private.config"),
            importlib.import_module(f"{pkg}.observability.tracing_plane"))


def _both(scenario, enabled=None):
    """``scenario(lockcheck, config, tracing_plane)`` through each
    package, with the verdict pinned to ``enabled`` (None: evaluated
    from the environment and the config) and reset afterwards."""
    out = []
    for pkg in PACKAGES:
        lockcheck, config, tracing_plane = _mods(pkg)
        lockcheck.reset(enabled_override=enabled)
        try:
            out.append(scenario(lockcheck, config, tracing_plane))
        finally:
            lockcheck.reset()
    return out


def _run_threads(*fns):
    for fn in fns:   # sequential: the graph, not a deadlock
        t = threading.Thread(target=fn)
        t.start()
        t.join()


def _summary(reports):
    out = []
    for r in reports:
        if r["kind"] == "cycle":
            out.append(("cycle", sorted(r["cycle"]), len(set(r["nodes"])),
                        len(r["stacks"]), r["order"].count(" -> ")))
        else:
            out.append(("long-hold", r["lock"], r["blocking"],
                        r["budget_s"], r["held_s"] > r["budget_s"]))
    return out


# ---------------------------------------------- tests/test_lint.py :581-745

def test_lockcheck_off_returns_plain_locks():
    """Disabled, the factories hand back the exact stdlib primitives —
    zero wrapper, zero overhead."""
    def scenario(lockcheck, config, tracing_plane):
        return (type(lockcheck.make_lock("x")) is type(threading.Lock()),
                type(lockcheck.make_rlock("x")) is type(threading.RLock()))

    want, got = _both(scenario, enabled=False)
    assert want == got == (True, True)


def test_lockcheck_detects_seeded_inversion_on_two_threads():
    def scenario(lockcheck, config, tracing_plane):
        a = lockcheck.make_lock("test.A")
        b = lockcheck.make_lock("test.B")

        def a_then_b():
            with a:
                with b:
                    pass

        def b_then_a():
            with b:
                with a:
                    pass

        _run_threads(a_then_b, b_then_a)
        spans = [s for s in tracing_plane.recorder().snapshot()
                 if s["name"] == "lockcheck:cycle"]
        return (_summary(lockcheck.reports()), bool(spans),
                spans[-1]["error"] if spans else None,
                spans[-1].get("attrs", {}).get("order") if spans else None)

    want, got = _both(scenario, enabled=True)
    # One cycle over both locks, both edges' acquire stacks, and the
    # report rode the flight recorder's force-sampled ring.
    assert want == got == ([("cycle", ["test.A", "test.B"], 2, 2, 2)], True,
                           True, "test.B -> test.A -> test.B")


def test_lockcheck_consistent_order_reports_nothing():
    def scenario(lockcheck, config, tracing_plane):
        a = lockcheck.make_lock("test.C")
        b = lockcheck.make_lock("test.D")
        for _ in range(3):
            with a:
                with b:
                    pass
        return lockcheck.reports(), sorted(
            (k.split("#")[0], sorted(n.split("#")[0] for n in v))
            for k, v in lockcheck.edges().items())

    want, got = _both(scenario, enabled=True)
    assert want == got == ([], [("test.C", ["test.D"])])


def test_lockcheck_long_hold_over_blocking_call():
    def scenario(lockcheck, config, tracing_plane):
        saved = config.global_config().lockcheck_hold_budget_s
        config.global_config().lockcheck_hold_budget_s = 0.01
        try:
            lock = lockcheck.make_lock("test.hold")
            with lock:
                lockcheck.note_blocking("RpcClient.call:LeaseWorker")
                time.sleep(0.05)
            first = _summary(lockcheck.reports())
            # A long hold WITHOUT a blocking call is not reported: the
            # budget is about holding locks across I/O, not about slow
            # pure-compute sections.
            with lock:
                time.sleep(0.05)
            return first, _summary(lockcheck.reports())
        finally:
            config.global_config().lockcheck_hold_budget_s = saved

    want, got = _both(scenario, enabled=True)
    hold = ("long-hold", "test.hold", "RpcClient.call:LeaseWorker", 0.01,
            True)
    assert want == got == ([hold], [hold])


def test_lockcheck_same_name_instances_still_invert():
    """Two instances sharing one name taken A→B / B→A are a REAL
    inversion: the graph keys on instance, not name."""
    def scenario(lockcheck, config, tracing_plane):
        a = lockcheck.make_lock("memory_store")
        b = lockcheck.make_lock("memory_store")

        def run(f, s):
            with f:
                with s:
                    pass

        _run_threads(lambda: run(a, b), lambda: run(b, a))
        cycles = [r for r in lockcheck.reports() if r["kind"] == "cycle"]
        return [(c["cycle"], len(set(c["nodes"]))) for c in cycles]

    want, got = _both(scenario, enabled=True)
    assert want == got == [(["memory_store", "memory_store"], 2)]


def test_lockcheck_edges_of_different_instances_do_not_merge():
    """X→pool#1 on one thread plus pool#2→X on another share a NAME but
    not an instance — stitching them into a cycle would be a false
    positive."""
    def scenario(lockcheck, config, tracing_plane):
        x = lockcheck.make_lock("X")
        p1 = lockcheck.make_lock("rpc.client_pool")
        p2 = lockcheck.make_lock("rpc.client_pool")

        def x_then_p1():
            with x:
                with p1:
                    pass

        def p2_then_x():
            with p2:
                with x:
                    pass

        _run_threads(x_then_p1, p2_then_x)
        return [r for r in lockcheck.reports() if r["kind"] == "cycle"]

    want, got = _both(scenario, enabled=True)
    assert want == got == []


def test_lockcheck_system_config_channel_survives_cached_verdict():
    """Import-time factory calls cache a pre-init verdict;
    ``refresh_enabled()`` (which ``init`` calls) makes the
    ``_system_config`` channel live."""
    def scenario(lockcheck, config, tracing_plane):
        saved = config.global_config().lockcheck
        try:
            plain = type(lockcheck.make_lock("x")) is type(threading.Lock())
            config.global_config().lockcheck = True
            refreshed = lockcheck.refresh_enabled()
            return plain, refreshed, isinstance(lockcheck.make_lock("x"),
                                                lockcheck.InstrumentedLock)
        finally:
            config.global_config().lockcheck = saved

    want, got = _both(scenario, enabled=False)
    assert want == got == (True, True, True)


def test_lockcheck_rlock_reentry_is_not_an_inversion():
    def scenario(lockcheck, config, tracing_plane):
        r = lockcheck.make_rlock("test.R")
        with r:
            with r:
                pass
        return lockcheck.reports(), lockcheck.edges()

    want, got = _both(scenario, enabled=True)
    assert want == got == ([], {})


def test_lockcheck_note_blocking_is_noop_when_disabled():
    def scenario(lockcheck, config, tracing_plane):
        lockcheck.note_blocking("anything")   # must not blow up
        return lockcheck.reports()

    want, got = _both(scenario, enabled=False)
    assert want == got == []


# ------------------------------------------------------------- the port

def test_lockcheck_env_channel_and_log_line(monkeypatch, caplog):
    """``ART_LOCKCHECK=1`` turns the detector on (the channel spawned
    processes inherit), and a report logs ``LOCKCHECK: ...`` at error
    level on the process's log, as in the JAX package."""
    from ant_ray_tpu_torch._lint import lockcheck

    monkeypatch.setenv("ART_LOCKCHECK", "1")
    lockcheck.reset()
    try:
        assert lockcheck.enabled() is True
        a, b = lockcheck.make_lock("log.A"), lockcheck.make_lock("log.B")
        with caplog.at_level(logging.ERROR,
                             logger="ant_ray_tpu_torch._lint.lockcheck"):
            _run_threads(lambda: [a.acquire(), b.acquire(), b.release(),
                                  a.release()],
                         lambda: [b.acquire(), a.acquire(), a.release(),
                                  b.release()])
        assert [r.getMessage() for r in caplog.records] == [
            "LOCKCHECK: lock-order inversion (potential deadlock): "
            "log.B -> log.A -> log.B"]
    finally:
        monkeypatch.delenv("ART_LOCKCHECK")
        lockcheck.reset()
    assert lockcheck.enabled() is False


def test_instrumented_lock_keeps_the_lock_api():
    """acquire/release with blocking and timeout, ``locked()``, and a
    non-LIFO release, as the planes use them."""
    from ant_ray_tpu_torch._lint import lockcheck

    lockcheck.reset(enabled_override=True)
    try:
        a, b = lockcheck.make_lock("api.A"), lockcheck.make_lock("api.B")
        assert a.acquire() and a.locked()
        assert b.acquire(timeout=1)
        assert not a.acquire(blocking=False)
        a.release()                       # out of order
        b.release()
        assert not a.locked() and not b.locked()
        assert lockcheck.reports() == []
    finally:
        lockcheck.reset()


def test_a_cluster_with_lockcheck_reports_no_cycle():
    """A port cluster started with ``_system_config={"lockcheck":
    True}``: the driver instruments its locks, every spawned process
    inherits ``ART_LOCKCHECK``, tasks, actor calls and puts run, and no
    process's log holds a cycle report."""
    import ant_ray_tpu_torch as art
    from ant_ray_tpu_torch._lint import lockcheck
    from ant_ray_tpu_torch._private.config import (global_config,
                                                   set_global_config)

    saved = global_config()
    art.init(num_cpus=2, _system_config={"lockcheck": True})
    try:
        from ant_ray_tpu_torch._private.worker import global_worker

        assert lockcheck.enabled()
        assert isinstance(lockcheck.make_lock("driver.probe"),
                          lockcheck.InstrumentedLock)

        @art.remote
        def where():
            from ant_ray_tpu_torch._lint import lockcheck as lc

            return os.environ.get("ART_LOCKCHECK"), lc.enabled()

        @art.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        assert art.get([where.remote() for _ in range(4)]) == \
            [("True", True)] * 4
        c = Counter.remote()
        assert art.get([c.add.remote(i) for i in range(10)])[-1] == 45
        refs = [art.put(bytes(200_000)) for _ in range(5)]
        assert all(len(v) == 200_000 for v in art.get(refs))
        logs = os.path.join(global_worker.runtime.session_dir, "logs")
        texts = {}
        for name in sorted(os.listdir(logs)):
            with open(os.path.join(logs, name), errors="replace") as f:
                texts[name] = f.read()
    finally:
        art.shutdown()
        set_global_config(saved)   # the config outlives shutdown()
        driver_cycles = [r for r in lockcheck.reports()
                         if r["kind"] == "cycle"]
        lockcheck.reset()
    assert {"gcs.err", "noded.err"} <= set(texts)
    assert any(n.startswith("worker-") for n in texts)
    assert [n for n, t in texts.items() if "lock-order inversion" in t] == []
    assert driver_cycles == []
    assert "ART_LOCKCHECK" not in os.environ
