"""Worker output streaming and orphan reaping in the port against the JAX
package: the twins of tests/test_log_streaming.py — a task's prints reach
the driver's console with their source prefix, the worker's own system
lines do not, and a user subprocess orphaned by its worker's death is
killed by the node daemon — each in a fresh ``init(num_cpus=1)``
cluster of each package in turn (the reference's fixture is per test),
the driver's output captured for each package alone.  The lines seen and
the verdicts must be equal."""

import os
import subprocess
import sys
import time

import pytest

from runtime_twins import PACKAGES, wait_for


def _in_one_cpu_cluster(scenario, *args):
    outs = []
    for art in PACKAGES:
        art.init(num_cpus=1)
        try:
            outs.append(scenario(art, *args))
        finally:
            art.shutdown()
    return outs


def test_task_prints_reach_driver(capfd):
    def scenario(art):
        capfd.readouterr()

        @art.remote
        def chatty(i):
            print(f"log-stream-probe-{i}")
            return i

        values = art.get([chatty.remote(i) for i in range(3)])
        seen = ""

        def all_seen():
            nonlocal seen
            seen += capfd.readouterr().out
            return all(f"log-stream-probe-{i}" in seen for i in range(3))

        wait_for(all_seen, 15, 0.2)
        probes = sorted(line.split()[-1] for line in seen.splitlines()
                        if "log-stream-probe-" in line)
        assert probes == [f"log-stream-probe-{i}" for i in range(3)], \
            seen[-2000:]
        # The source prefix on every streamed line; the worker's own
        # system logging format filtered out.
        assert "(worker=" in seen and "pid=" in seen
        assert "[worker " not in seen
        return values, probes

    want, got = _in_one_cpu_cluster(scenario)
    assert got == want
    assert got[0] == [0, 1, 2]


def test_system_log_lines_not_streamed(capfd):
    """The worker's boot line ('[worker INFO ...] serving at ...') lands
    in its log file, not on the driver's console."""
    def scenario(art):
        capfd.readouterr()

        @art.remote
        def quiet():
            return "ok"

        value = art.get(quiet.remote())
        time.sleep(1.0)
        out = capfd.readouterr().out
        assert "serving at" not in out, out[-2000:]
        return value, "serving at" in out

    want, got = _in_one_cpu_cluster(scenario)
    assert got == want == ("ok", False)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="subreaper is linux-only")
def test_orphaned_grandchild_is_reaped():
    """A worker that dies with a live user subprocess does not leak it:
    the subreaper re-parents the orphan to the node daemon, whose sweep
    kills it within a few seconds."""
    def scenario(art):
        @art.remote
        class Spawner:
            def spawn(self):
                proc = subprocess.Popen([sys.executable, "-c",
                                         "import time; time.sleep(300)"])
                self._proc = proc
                return proc.pid

        actor = Spawner.remote()
        orphan_pid = art.get(actor.spawn.remote())
        alive_before = _alive(orphan_pid)
        art.kill(actor)                  # worker dies, orphan re-parents
        reaped = wait_for(lambda: not _alive(orphan_pid), 15, 0.5)
        assert reaped, f"{art.__name__}: orphan {orphan_pid} survived"
        return alive_before, reaped

    want, got = _in_one_cpu_cluster(scenario)
    assert got == want == (True, True)
