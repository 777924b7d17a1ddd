"""The node daemon's memory and disk monitors in the port against the JAX
package: the twins of tests/test_memory_monitor.py — meminfo parsing,
a worker killed under faked memory pressure whose task is retried, a
node over its disk threshold that takes no lease — the cluster ones in
a cluster of each package in turn (their ``_system_config`` reaches the
processes as ``ART_*`` variables, which both packages read).  Values and
exceptions (type and masked message) must be equal."""

import time

import pytest

from runtime_twins import both, mod, outcome


def _write_meminfo(path, total_kb, available_kb):
    path.write_text(
        f"MemTotal:       {total_kb} kB\n"
        f"MemFree:        {available_kb} kB\n"
        f"MemAvailable:   {available_kb} kB\n")


def test_used_fraction_parsing(tmp_path):
    f = tmp_path / "meminfo"
    _write_meminfo(f, 100_000, 30_000)

    def scenario(art):
        read = mod(art, "_private.node_daemon").NodeManager \
            ._read_memory_used_fraction
        return read(str(f)), read(str(tmp_path / "nope"))

    want, got = both(scenario)
    assert got == want
    assert got[0] == pytest.approx(0.7) and got[1] is None


@pytest.mark.slow
def test_oom_kill_retries_task(tmp_path):
    """Under faked pressure the daemon kills the leased worker; the task
    retries and completes once the pressure clears."""
    def scenario(art):
        meminfo = tmp_path / f"{art.__name__}.meminfo"
        _write_meminfo(meminfo, 100_000, 50_000)  # healthy at boot
        art.init(num_cpus=2, _system_config={
            "meminfo_path": str(meminfo),
            "memory_monitor_interval_s": 0.2,
            "memory_usage_threshold": 0.9,
        })
        try:
            marker = tmp_path / f"{art.__name__}.attempts"

            @art.remote(max_retries=4)
            def pressured():
                with open(marker, "a") as f:
                    f.write("x")
                time.sleep(3.0)  # long enough for the monitor to strike
                return "done"

            ref = pressured.remote()
            time.sleep(1.0)  # the task is running on a leased worker
            _write_meminfo(meminfo, 100_000, 2_000)   # 98% used
            time.sleep(0.5)                           # the monitor kills
            _write_meminfo(meminfo, 100_000, 50_000)  # pressure clears
            value = art.get(ref, timeout=120)
            died = marker.read_text().count("x") >= 2
            assert value == "done" and died, art.__name__
            return value, died
        finally:
            art.shutdown()

    want, got = both(scenario)
    assert got == want == ("done", True)


@pytest.mark.slow
def test_disk_full_node_rejects_new_leases():
    """A node over the disk-capacity threshold takes no lease."""
    def scenario(art):
        cluster = mod(art, "cluster_utils").Cluster(head_node_args={
            "num_cpus": 2,
            "_system_config": {"local_fs_capacity_threshold": 0.0,
                               "fs_monitor_interval_s": 0.1,
                               "lease_retry_deadline_s": 5.0}})
        cluster.connect()
        try:
            time.sleep(0.5)  # the monitor takes its first reading

            @art.remote
            def f():
                return 1

            result = outcome(lambda: art.get(f.remote(), timeout=30))
            assert result[0] == "raise" and any(
                w in str(result) for w in ("out of disk", "scheduled"))
            return result
        finally:
            art.shutdown()
            cluster.shutdown()

    want, got = both(scenario)
    assert got == want
    assert got[0] == "raise"


def test_packages_share_the_monitor_flags():
    """The monitors' flags (the slow twins' ``_system_config``) are the
    same names with the same defaults in both packages."""
    names = ("meminfo_path", "memory_monitor_interval_s",
             "memory_usage_threshold", "local_fs_capacity_threshold",
             "fs_monitor_interval_s", "lease_retry_deadline_s")

    def scenario(art):
        config = mod(art, "_private.config").Config()
        return {n: getattr(config, n) for n in names}

    want, got = both(scenario)
    assert got == want
