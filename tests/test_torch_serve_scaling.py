"""Serve's scaling plane of the port (serve/api.py) against the JAX
package's, under real load: queue-depth autoscaling up and back down,
the long-poll push of a scale-up to a handle, and the suspect plane
that ejects a wedged replica.  Each scenario is one of
tests/test_serve.py or tests/test_serve_overload.py (marked slow
there), keeps the reference's assertions, and runs through both
packages, each in its own cluster (started without
``_system_config``); the outcomes must be equal."""

import os
import signal
import threading
import time

from test_torch_serve import _both, _replica_count, clusters  # noqa: F401


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
        pump = _Pump(art, handle, 6, 6)
        grown = 0
        while time.monotonic() < pump.until:
            grown = max(grown, _replica_count(art, serve, "scaly"))
            if grown >= 2:
                break
            time.sleep(0.25)
        pump.join()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if _replica_count(art, serve, "scaly") == 1:
                break
            time.sleep(0.5)
        return start, grown >= 2, _replica_count(art, serve, "scaly")

    want, got = _both(scenario)
    assert got == want == (1, True, 1)


def test_scale_up_pushed_to_handle_without_ttl(clusters):
    """A scale-up reaches the handle's routing state well inside the
    fallback TTL: the controller pushes the new replica set."""
    def scenario(art, serve):
        assert serve.api.DeploymentHandle._REFRESH_TTL_S >= 10
        dep = serve.deployment(
            Sleepy, name="pushy",
            autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                "target_ongoing_requests": 1.0,
                                "downscale_patience": 2})
        handle = serve.run(dep.bind(0.8))
        before = len(handle._routing.replicas)
        handle.remote(0)                      # arm the listener
        start = time.monotonic()
        pump = _Pump(art, handle, 8, 5)
        observed_at = None
        while time.monotonic() < pump.until:
            if len(handle._routing.replicas) >= 2:
                observed_at = time.monotonic() - start
                break
            time.sleep(0.1)
        pump.join()
        return (before, observed_at is not None and observed_at
                < serve.api.DeploymentHandle._REFRESH_TTL_S / 2)

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
            marked = bool(h._routing.suspect)
            routed = [h.call(timeout_s=2.0) == survivor for _ in range(8)]
            opened = any(br.state == "open"
                         for br in h._routing.breakers.values())
        finally:
            os.kill(victim, signal.SIGCONT)
        deadline = time.monotonic() + 20
        while h._routing.suspect and time.monotonic() < deadline:
            time.sleep(0.2)
        cleared = not h._routing.suspect
        seen = set()
        deadline = time.monotonic() + 15
        while seen != pids and time.monotonic() < deadline:
            seen.add(h.call(timeout_s=5))
        return marked, routed, opened, cleared, seen == pids

    want, got = _both(scenario)
    assert got == want == (True, [True] * 8, True, True, True)
