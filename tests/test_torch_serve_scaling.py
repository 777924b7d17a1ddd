"""Serve's scaling plane of the port (serve/api.py) against the JAX
package's, under real load: queue-depth autoscaling up and back down,
the long-poll push of a scale-up to a handle, and the suspect plane
that ejects a wedged replica.  Each scenario is one of
tests/test_serve.py or tests/test_serve_overload.py (marked slow
there), keeps the reference's assertions, and runs through both
packages, each in its own cluster (started without
``_system_config``); the outcomes must be equal.

Where the reference waits fixed windows of wall clock (a 6 s pump, a
push seen within half the TTL, 2 s calls), these wait on each condition
under WAIT_S, so that a host loaded by the rest of the suite slows them
down without failing them: the pump runs until the scale-up is seen,
the TTL test sets the fallback TTL to an hour in both packages (any
update the handle sees came from the push), and calls get a timeout
that survives the suite's load.  A wrong outcome still shows as
unequal tuples."""

import os
import signal
import threading
import time

from test_torch_serve import _both, _replica_count, clusters  # noqa: F401

WAIT_S = 60       # per condition
CALL_S = 30       # per call through the handle


class _Pump:
    """``threads`` callers sending through ``handle`` for up to
    ``seconds`` (the reference's load), stopped early by ``join``."""

    def __init__(self, art, handle, seconds, threads):
        self.until = time.monotonic() + seconds
        self._done = threading.Event()

        def pump():
            while time.monotonic() < self.until and not self._done.is_set():
                try:
                    art.get(handle.remote(1), timeout=30)
                except Exception:  # noqa: BLE001 — the reference's pump
                    return

        self._threads = [threading.Thread(target=pump)
                         for _ in range(threads)]
        for t in self._threads:
            t.start()

    def join(self):
        self._done.set()
        for t in self._threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in self._threads)


class Sleepy:
    def __init__(self, sleep_s):
        self.sleep_s = sleep_s

    def __call__(self, x):
        time.sleep(self.sleep_s)
        return x


def test_autoscaling_follows_load(clusters):
    """Replica count rises under queued load and returns to min when
    idle."""
    def scenario(art, serve):
        dep = serve.deployment(
            Sleepy, name="scaly",
            autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                "target_ongoing_requests": 1.0,
                                "downscale_patience": 2})
        handle = serve.run(dep.bind(1.0))
        start = _replica_count(art, serve, "scaly")
        pump = _Pump(art, handle, WAIT_S, 6)
        grown = 0
        while time.monotonic() < pump.until:
            grown = max(grown, _replica_count(art, serve, "scaly"))
            if grown >= 2:
                break
            time.sleep(0.25)
        pump.join()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            if _replica_count(art, serve, "scaly") == 1:
                break
            time.sleep(0.5)
        return start, grown >= 2, _replica_count(art, serve, "scaly")

    want, got = _both(scenario)
    assert got == want == (1, True, 1)


def test_scale_up_pushed_to_handle_without_ttl(clusters, monkeypatch):
    """A scale-up reaches the handle's routing state without the
    fallback TTL: with the TTL set to an hour, the new replica set can
    only have come from the controller's push."""
    def scenario(art, serve):
        handle_cls = serve.api.DeploymentHandle
        assert handle_cls._REFRESH_TTL_S >= 10
        monkeypatch.setattr(handle_cls, "_REFRESH_TTL_S", 3600.0)
        dep = serve.deployment(
            Sleepy, name="pushy",
            autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                "target_ongoing_requests": 1.0,
                                "downscale_patience": 2})
        handle = serve.run(dep.bind(0.8))
        before = len(handle._routing.replicas)
        handle.remote(0)                      # arm the listener
        pump = _Pump(art, handle, WAIT_S, 5)
        pushed = False
        while time.monotonic() < pump.until:
            if len(handle._routing.replicas) >= 2:
                pushed = True
                break
            time.sleep(0.1)
        pump.join()
        return before, pushed

    want, got = _both(scenario)
    assert got == want == (1, True)


def test_ongoing_poll_strikes_eject_wedged_replica(clusters):
    """A WEDGED replica (SIGSTOP) is marked suspect by repeated poll
    timeouts, every handle's breaker opens against it (no traffic to
    it), and after SIGCONT a successful poll clears the mark and
    probation re-admits it."""
    def scenario(art, serve):
        @serve.deployment(name="wedge", num_replicas=2,
                          max_ongoing_requests=4,
                          breaker_config={"cooldown_s": 0.5})
        class Wedge:
            def __call__(self, x=None):
                return os.getpid()

        h = serve.run(Wedge.bind())
        pids = set()
        deadline = time.monotonic() + WAIT_S
        while len(pids) < 2 and time.monotonic() < deadline:
            pids.add(h.call(timeout_s=CALL_S))
        assert len(pids) == 2, pids
        victim = sorted(pids)[0]
        survivor = (pids - {victim}).pop()
        os.kill(victim, signal.SIGSTOP)
        try:
            deadline = time.monotonic() + WAIT_S
            while not h._routing.suspect and time.monotonic() < deadline:
                time.sleep(0.2)
            marked = bool(h._routing.suspect)
            # A call routed to the wedge would never answer: it would
            # raise at its timeout, or come back from the wrong pid.
            routed = [h.call(timeout_s=CALL_S) == survivor
                      for _ in range(8)]
            opened = any(br.state == "open"
                         for br in h._routing.breakers.values())
        finally:
            os.kill(victim, signal.SIGCONT)
        deadline = time.monotonic() + WAIT_S
        while h._routing.suspect and time.monotonic() < deadline:
            time.sleep(0.2)
        cleared = not h._routing.suspect
        seen = set()
        deadline = time.monotonic() + WAIT_S
        while seen != pids and time.monotonic() < deadline:
            seen.add(h.call(timeout_s=CALL_S))
        return marked, routed, opened, cleared, seen == pids

    want, got = _both(scenario)
    assert got == want == (True, [True] * 8, True, True, True)
