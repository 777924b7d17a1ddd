"""The port's continuous CPU profiler (``observability/cpu_profiler.py``)
against the JAX package's, each scenario of tests/test_cpu_profiler.py
run through both with the same inputs: bounded aggregation, the
folded-stack algebra (``merge_folded``, ``render_folded``, ``self_time``,
``diff_folded``) on records made from a seeded numpy generator, delta
publication, the wire accounting both protocols keep, the GCS's io-loop
duty read from real samples, and a live cluster of each package whose
driver, GCS, daemon and workers publish to one ring.

The reference's overhead case bounds the wall cost per sample (300 µs),
which the suite's load makes unsteady; here the sampler is held to its
sample count and to the busy thread's frames, and chip_smoke.py holds
the 300-µs bound on the card's quiet host.  The ring merge across GCS
replicas came with GCS HA: two in-process replicas of each package,
each holding its own shard, answer the same merged reads."""

import threading
import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu._private import protocol as jprotocol
from ant_ray_tpu._private.gcs import GcsServer as JGcsServer
from ant_ray_tpu.observability import cpu_profiler as jprof
from ant_ray_tpu_torch._private import protocol as tprotocol
from ant_ray_tpu_torch._private.gcs import GcsServer as TGcsServer
from ant_ray_tpu_torch.observability import cpu_profiler as tprof

PACKAGES = [(jart, jprof), (tart, tprof)]
IDS = ["jax", "port"]


def _wait(predicate, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _records(seed: int, n: int = 12) -> list[dict]:
    """CpuProfile ring records with folded stacks drawn from a seeded
    generator: a few process classes and roles over a small frame set,
    so stacks repeat across records and leaves are shared."""
    rng = np.random.default_rng(seed)
    procs = ["driver", "gcs", "daemon", "worker"]
    frames = [f"mod{i}:fn{j}" for i in range(4) for j in range(3)]
    out = []
    for r in range(n):
        stacks = {}
        for _ in range(int(rng.integers(3, 9))):
            depth = int(rng.integers(1, 6))
            key = ";".join([procs[int(rng.integers(len(procs)))],
                            ["MainThread", "art-io"][int(rng.integers(2))],
                            *(frames[int(i)] for i in
                              rng.integers(0, len(frames), depth))])
            stacks[key] = stacks.get(key, 0) + int(rng.integers(1, 50))
        out.append({"node_id": "n", "pid": 1, "proc": "p",
                    "ts": 1000.0 + r, "dur_s": 1.0, "hz": 67.0,
                    "samples": sum(stacks.values()), "stacks": stacks})
    return out


# ---------------------------------------------------- sampler


def _busy_capture(prof_mod):
    """The reference's overhead scenario without its wall-clock bound:
    a busy thread sampled at 101 Hz until 30 samples landed."""
    prof = prof_mod.CpuProfiler("unittest", hz=101.0, publish_period_s=60.0,
                                publish_fn=lambda record: None).start()
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(i * i for i in range(1000))

    worker = threading.Thread(target=busy, daemon=True)
    worker.start()
    try:
        _wait(lambda: prof.overhead_stats()["samples"] >= 30,
              what="30 profiler samples")
    finally:
        stop.set()
        worker.join()
        prof.stop(final_publish=False)
    stats = prof.overhead_stats()
    keys = prof.snapshot()
    return {"stats_keys": sorted(stats),
            "enough_samples": stats["samples"] >= 30,
            "cost_positive": stats["avg_sample_cost_s"] > 0,
            "busy_seen": any(":busy" in key for key in keys),
            "proc_first": all(key.startswith("unittest;") for key in keys)}


def test_sampler_captures_the_busy_thread_in_both():
    outcomes = [_busy_capture(prof) for _art, prof in PACKAGES]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] == {
        "stats_keys": ["avg_sample_cost_s", "overhead_fraction", "samples"],
        "enough_samples": True, "cost_positive": True, "busy_seen": True,
        "proc_first": True}


def test_bounded_aggregation_wraps_to_overflow_bucket():
    snapshots = []
    for _art, prof_mod in PACKAGES:
        prof = prof_mod.CpuProfiler("unittest", hz=1.0, max_stacks=4)
        for i in range(10):
            prof._count(f"unittest;main;f{i}")
        snapshots.append(prof.snapshot())
    assert snapshots[0] == snapshots[1]
    stacks = snapshots[1]
    assert len(stacks) == 5
    assert stacks["unittest;(overflow)"] == 6
    assert sum(stacks.values()) == 10


@pytest.mark.parametrize("top_n", [3, 200])
def test_delta_records_equal_the_reference(top_n, monkeypatch):
    """Two publishes of the same counted stacks: the first ships
    everything (truncated past the top-N cap into one bucket), the
    second only what was counted since, and an idle period none."""
    rng = np.random.default_rng(7)
    keys = [f"unittest;main;f{i}" for i in range(12)]
    counts = rng.integers(1, 20, (2, len(keys)))
    got = []
    for _art, prof_mod in PACKAGES:
        monkeypatch.setattr(prof_mod, "_PUBLISH_TOP_N", top_n)
        prof = prof_mod.CpuProfiler("unittest", hz=1.0, node_id="node-a")
        records = []
        for round_counts in counts:
            for key, n in zip(keys, round_counts):
                prof._count(key, int(n))
            prof._samples += 1
            records.append(prof._delta_record())
        records.append(prof._delta_record())
        got.append([None if r is None else
                    {k: v for k, v in r.items()
                     if k not in ("ts", "dur_s", "pid")}
                    for r in records])
    assert got[0] == got[1]
    assert got[1][2] is None
    assert sum(got[1][1]["stacks"].values()) == int(counts[1].sum())


# ------------------------------------------------- folded-stack algebra


def test_diff_folded_ranks_by_self_time_delta():
    a = {"p;main;f1;hot": 10, "p;main;f1;cold": 50, "p;main;gone": 5}
    b = {"p;main;f1;hot": 40, "p;main;f2;hot": 10, "p;main;f1;cold": 50}
    for _art, prof in PACKAGES:
        rows = prof.diff_folded(a, b)
        assert rows[0] == ("hot", 40, 10, 50)
        assert rows[-1] == ("gone", -5, 5, 0)
        assert all(frame != "cold" for frame, *_ in rows)
        assert prof.self_time(b)["hot"] == 50
        merged = prof.merge_folded([{"stacks": a}, {"stacks": b}])
        assert merged["p;main;f1;hot"] == 50
        assert prof.render_folded(merged).splitlines()[0].endswith(" 100")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_algebra_equals_the_reference(seed):
    a, b = _records(seed), _records(seed + 100)
    outs = []
    for _art, prof in PACKAGES:
        ma, mb = prof.merge_folded(a), prof.merge_folded(b)
        outs.append((ma, prof.render_folded(ma), prof.self_time(ma),
                     prof.diff_folded(ma, mb)))
    assert outs[0] == outs[1]
    merged = outs[1][0]
    assert sum(merged.values()) == sum(r["samples"] for r in a)


# ---------------------------------------------------- wire accounting


@pytest.mark.parametrize("protocol", [jprotocol, tprotocol], ids=IDS)
def test_wire_accounting_counts_known_calls(protocol):
    """N round trips on a method only this test uses, client and server
    in one process: each Echo frame is counted twice (send and recv),
    so frames == 2N per direction, exactly — in both protocols."""
    server = protocol.RpcServer()

    async def echo(payload):
        return payload

    server.route("Echo", echo)
    server.start()
    client = protocol.RpcClient(server.address)

    def echo_totals():
        totals = {}
        for direction in ("send", "recv"):
            entry = protocol.wire_counters.get(("Echo", direction))
            totals[direction] = tuple(entry) if entry else (0, 0, 0)
        return totals

    before = echo_totals()
    n = 7
    try:
        for i in range(n):
            assert client.call("Echo", {"i": i}, timeout=10) == {"i": i}
        after = echo_totals()
        for direction in ("send", "recv"):
            assert after[direction][0] - before[direction][0] == 2 * n
            assert after[direction][1] > before[direction][1]
        assert after["send"][2] > before["send"][2]
        assert client.wire_stats[("Echo", "send")][0] == n
        assert client.wire_stats[("Echo", "recv")][0] == n
    finally:
        client.close()
        server.stop()


def test_wire_metrics_publish_the_same_series():
    """The publish tick rolls the protocol's counter deltas into
    ``art_rpc_*`` counter records: the same names, tags and
    descriptions in both packages for the same calls."""
    names = []
    for (_art, prof_mod), protocol in zip(PACKAGES, (jprotocol, tprotocol)):
        server = protocol.RpcServer()

        async def echo(payload):
            return payload

        server.route("EchoMetric", echo)
        server.start()
        client = protocol.RpcClient(server.address)
        try:
            protocol.wire_deltas()
            protocol.handle_deltas()
            for i in range(3):
                client.call("EchoMetric", {"i": i}, timeout=10)
            seen = []
            prof = prof_mod.CpuProfiler("unittest", hz=1.0, node_id="n",
                                        metric_fn=seen.append)
            prof._publish_wire_metrics()
        finally:
            client.close()
            server.stop()
        names.append(sorted(
            (m["name"], m["type"], tuple(sorted(m["tags"])),
             m["description"]) for m in seen
            if m["tags"].get("method") == "EchoMetric"))
    assert names[0] == names[1]
    assert {n for n, *_ in names[1]} == {
        "art_rpc_bytes_total", "art_rpc_encode_seconds_total",
        "art_rpc_frames_total", "art_rpc_handle_seconds_total",
        "art_rpc_handled_total"}


def test_module_singleton_is_idempotent_and_off_at_zero_hz():
    for _art, prof_mod in PACKAGES:
        assert prof_mod.profiler() is None
        assert prof_mod.start("unittest", hz=0) is None
        first = prof_mod.start("unittest", hz=50.0, publish_period_s=60.0,
                               publish_fn=lambda record: None)
        try:
            assert prof_mod.start("other") is first
            assert prof_mod.profiler() is first
        finally:
            prof_mod.stop()
        assert prof_mod.profiler() is None


# ------------------------------------------------------- GCS


def test_gcs_io_loop_duty_reads_real_samples():
    """A GCS of each package profiles itself: its ring fills with its
    own records and ``_io_loop_duty`` reads a busy fraction in [0, 1]
    from the io thread's samples."""
    for server_cls in (JGcsServer, TGcsServer):
        server = server_cls()
        server.start()
        try:
            assert server._cpu_profiler is not None
            _wait(lambda s=server: s._cpu_profiler.overhead_stats()[
                "samples"] >= 20, what="GCS samples")
            server._io_loop_duty()
            time.sleep(0.3)
            duty = server._io_loop_duty()
            assert duty is not None and 0.0 <= duty <= 1.0, duty
            server._cpu_profiler._publish()
            assert any(r["proc"] == "gcs" and r["node_id"] == "gcs"
                       for r in server._cpu_profile)
        finally:
            server.stop()


def _ring_merge(server_cls, protocol, cfg, monkeypatch, store):
    """The reference's scenario: CpuProfileAdd is any-replica ingestion
    (a sharded ring); a read through either replica merges every shard
    at query time, ``local_only`` confines it to one shard, and a
    ``node_id`` prefix composes with the merge.  Returns each read."""
    monkeypatch.setattr(cfg, "gcs_ha_lease_ttl_s", 0.8)
    monkeypatch.setattr(cfg, "gcs_ha_renew_period_s", 0.15)
    monkeypatch.setattr(cfg, "gcs_ha_sync_period_s", 0.1)
    leader = server_cls(store_path=store, ha_replica_id="ra")
    leader.start()
    assert leader._ha.wait_until_leader(10), "first replica never led"
    standby = server_cls(store_path=store, ha_replica_id="rb")
    standby.start()
    pool = protocol.ClientPool()
    try:
        _wait(lambda: standby._ha.leader_addr() == leader.address,
              what="standby to sync the leader ad")
        _wait(lambda: standby.address in leader._ha.peer_addresses(),
              what="leader to see the standby's ad")

        def record(node, ts):
            return {"node_id": node, "pid": 1, "proc": "shardtest",
                    "ts": ts, "dur_s": 1.0, "hz": 67.0, "samples": 3,
                    "stacks": {f"shardtest;main;{node}": 3}}

        t0 = time.time()
        pool.get(leader.address).call(
            "CpuProfileAdd", {"records": [record("node-a", t0)]},
            timeout=5)
        pool.get(standby.address).call(
            "CpuProfileAdd", {"records": [record("node-b", t0 + 1)]},
            timeout=5)

        def fetch(addr, **extra):
            payload = {"proc": "shardtest", **extra}
            return [r["node_id"] for r in pool.get(addr).call(
                "CpuProfileGet", payload, timeout=10) or []]

        out = {}
        for name, addr in (("leader", leader.address),
                           ("standby", standby.address)):
            _wait(lambda a=addr: set(fetch(a)) == {"node-a", "node-b"},
                  what=f"merged CpuProfileGet via {addr}")
            out[name] = fetch(addr)
            out[name + "_local"] = fetch(addr, local_only=True)
        out["prefix"] = fetch(leader.address, node_id="node-b")
        # Each replica's own profiler names its replica.
        for server in (leader, standby):
            server._cpu_profiler._publish()
        out["gcs_node_ids"] = sorted({
            r["node_id"] for server in (leader, standby)
            for r in server._cpu_profile if r["proc"] == "gcs"})
        return out
    finally:
        for server in (standby, leader):
            try:
                server.stop()
            except Exception:  # noqa: BLE001 — already stopped
                pass
        pool.close_all()


def test_ring_merge_across_replicas_stays_with_gcs_ha(monkeypatch,
                                                     tmp_path):
    """The CpuProfile ring merges across GCS replicas at query time in
    the port as in the JAX package: both read shards in ts order
    through either replica, one shard with ``local_only``."""
    from ant_ray_tpu._private.config import global_config as jcfg
    from ant_ray_tpu_torch._private.config import global_config as tcfg

    outs = [_ring_merge(cls, protocol, cfg(), monkeypatch,
                        str(tmp_path / f"{name}.db"))
            for cls, protocol, cfg, name in (
                (JGcsServer, jprotocol, jcfg, "jax"),
                (TGcsServer, tprotocol, tcfg, "port"))]
    assert outs[0] == outs[1]
    assert outs[1] == {
        "leader": ["node-a", "node-b"], "leader_local": ["node-a"],
        "standby": ["node-a", "node-b"], "standby_local": ["node-b"],
        "prefix": ["node-b"], "gcs_node_ids": ["gcs-ra", "gcs-rb"]}


# -------------------------------------------------------- cluster e2e


def _capture(art):
    """The reference's multiprocess scenario: an actor spins while the
    ring is read until driver, daemon and worker records landed."""
    worker_mod = __import__(art.__name__ + "._private.worker",
                            fromlist=["global_worker"])
    prof_mod = jprof if art is jart else tprof

    @art.remote
    class Spin:
        def work(self, n):
            return sum(i * i for i in range(n))

    actor = Spin.remote()
    t0 = time.time()
    runtime = worker_mod.global_worker.runtime

    def procs_seen():
        art.get([actor.work.remote(20000) for _ in range(20)])
        records = runtime._gcs.call(
            "CpuProfileGet", {"since_ts": t0}, retries=3) or []
        return {r["proc"] for r in records}

    _wait(lambda: {"driver", "gcs", "daemon", "worker"} <= procs_seen(),
          timeout=30.0, what="driver+gcs+daemon+worker profile records")
    records = runtime._gcs.call("CpuProfileGet", {"since_ts": t0},
                                retries=3) or []
    merged = prof_mod.merge_folded(records)
    art.kill(actor)
    return {"procs": {"driver", "gcs", "daemon", "worker"}
            <= {r["proc"] for r in records},
            "classes": {"driver", "gcs", "daemon", "worker"}
            <= {key.split(";", 1)[0] for key in merged},
            "windows": all(r["hz"] > 0 and r["dur_s"] > 0 for r in records),
            "keys": sorted(set().union(*(r.keys() for r in records)))}


def test_multiprocess_capture_merges_process_classes(monkeypatch):
    """A live cluster of each package (published every 0.4 s) merges
    driver, GCS, daemon and worker stacks in one CpuProfileGet."""
    monkeypatch.setenv("ART_CPU_PROFILE_PUBLISH_PERIOD_S", "0.4")
    outcomes = []
    for art in (jart, tart):
        art.init(num_cpus=2)
        try:
            outcomes.append(_capture(art))
        finally:
            art.shutdown()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1]["procs"] and outcomes[1]["classes"]
