"""The port's object transfer plane against the JAX package's: the
counterparts of tests/test_object_transfer.py (broadcast chunk dedup,
striped pulls, holder death mid-transfer, the pull window, the chunk
cache, raw chunk frames and the pull quota), each run on a multi-node
``Cluster`` of each package in turn with the same seeded payload, plus
a bf16 CPU tensor that crosses nodes in the port.

A scenario's ``_system_config`` reaches its daemons as ``ART_*``
variables, which both packages read, so the two packages never run a
cluster at the same time here: each scenario runs the JAX package's
cluster to its end, then the port's."""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart


def _pkg(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _payload(nbytes: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, 256, nbytes, dtype=np.uint8)


def _run(art, scenario, head_node_args):
    cluster = _pkg(art, "cluster_utils").Cluster(
        head_node_args=head_node_args)
    try:
        return scenario(art, cluster, _pkg(art, "_private.protocol")
                        .ClientPool())
    finally:
        art.shutdown()
        cluster.shutdown()


def _both(scenario, head_node_args):
    want = _run(jart, scenario, dict(head_node_args))
    got = _run(tart, scenario, dict(head_node_args))
    return want, got


def _ensure_local(pool, address, ref, timeout=120):
    reply = pool.get(address).call(
        "EnsureLocal", {"object_id": ref.id, "timeout": timeout,
                        "prefetch": True}, timeout=timeout + 60)
    assert reply.get("ok"), reply


def _read_log(pool, address, oid):
    stats = pool.get(address).call(
        "GetTransferStats", {"include_read_log": True}, timeout=10)
    return [(off, ln) for hex_id, off, ln in stats["read_log"]
            if hex_id == oid.hex()]


def _chunk_offsets(nbytes, chunk):
    return set(range(0, nbytes, chunk))


def _node_address(art):
    return _pkg(art, "_private.worker").global_worker.runtime.node_address


def broadcast_reads_each_chunk_once(art, cluster, pool):
    n_pullers = 8
    pullers = [cluster.add_node(num_cpus=1, labels={"puller": str(i)})
               for i in range(n_pullers)]
    cluster.connect()
    payload = _payload(2 * 1024 * 1024)
    n_chunks = (payload.nbytes + 256 * 1024 - 1) // (256 * 1024)
    ref = art.put(payload)

    @art.remote
    def fetch(arr):
        return int(arr.sum())

    refs = [fetch.options(num_cpus=1,
                          label_selector={"puller": str(i)}).remote(ref)
            for i in range(n_pullers)]
    sums = art.get(refs, timeout=180)
    reads = hits = 0
    for address in [_node_address(art)] + pullers:
        stats = pool.get(address).call("GetTransferStats", {}, timeout=10)
        reads += stats["chunk_reads"]
        hits += stats["chunk_cache_hits"]
    return (sums == [int(payload.sum())] * n_pullers,
            reads + hits >= n_chunks * n_pullers * 0.9,
            reads <= n_chunks * 3)


def striped_pull_two_holders_serve_disjoint_ranges(art, cluster, pool):
    chunk = 512 * 1024
    n1 = cluster.add_node(num_cpus=1)
    n2 = cluster.add_node(num_cpus=1)
    cluster.connect()
    ref = art.put(_payload(8 * 1024 * 1024))
    head = cluster._node_addresses[0]
    _ensure_local(pool, n1, ref)
    head_before = len(_read_log(pool, head, ref.id))
    _ensure_local(pool, n2, ref)
    head_log = _read_log(pool, head, ref.id)[head_before:]
    n1_log = _read_log(pool, n1, ref.id)
    head_served = {off for off, _ln in head_log}
    n1_served = {off for off, _ln in n1_log}
    stats = pool.get(n2).call("GetTransferStats", {}, timeout=10)
    return (bool(head_served) and bool(n1_served),
            head_served & n1_served,
            stats["stripe_pulls"] >= 1,
            head_served | n1_served == _chunk_offsets(stats["pull_bytes"],
                                                      chunk),
            len(head_log) == len(head_served), len(n1_log) == len(n1_served))


def striped_pull_survives_holder_death_mid_transfer(art, cluster, pool):
    chunk = 256 * 1024
    n1 = cluster.add_node(num_cpus=1)
    n2 = cluster.add_node(num_cpus=1, labels={"role": "sink"})
    cluster.connect()
    payload = _payload(8 * 1024 * 1024)
    ref = art.put(payload)
    head = cluster._node_addresses[0]
    _ensure_local(pool, n1, ref)
    head_before = len(_read_log(pool, head, ref.id))
    errors = []

    def pull():
        try:
            _ensure_local(pool, n2, ref, timeout=120)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=pull)
    t.start()
    # 32 chunks x 10 ms serve delay per holder stripe: killing at ~60 ms
    # lands mid-transfer.
    time.sleep(0.06)
    cluster.remove_node(n1)
    t.join(timeout=180)
    stats = pool.get(n2).call("GetTransferStats", {}, timeout=10)
    head_served = [off for off, _ln in
                   _read_log(pool, head, ref.id)[head_before:]]
    n_chunks = len(_chunk_offsets(stats["pull_bytes"], chunk))

    @art.remote
    def checksum(arr):
        return int(arr.sum())

    got = art.get(checksum.options(
        num_cpus=1, label_selector={"role": "sink"}).remote(ref), timeout=60)
    return (t.is_alive(), errors,
            len(head_served) == len(set(head_served)),
            stats["holder_failures"] >= 1,
            len(set(head_served)) > n_chunks // 2,
            got == int(payload.sum()))


def pull_window_one_is_sequential(art, cluster, pool):
    n1 = cluster.add_node(num_cpus=1)
    cluster.connect()
    payload = _payload(2 * 1024 * 1024)
    ref = art.put(payload)
    head = cluster._node_addresses[0]
    _ensure_local(pool, n1, ref)
    served = [off for off, _ln in _read_log(pool, head, ref.id)]
    stats = pool.get(n1).call("GetTransferStats", {}, timeout=10)
    return (served == sorted(served), len(served) == len(set(served)),
            stats["pull_bytes"] >= payload.nbytes)


def striped_pull_keeps_chunk_cache_memoized_and_bounded(art, cluster, pool):
    chunk = 256 * 1024
    cache_cap = 1024 * 1024
    n1 = cluster.add_node(num_cpus=1)
    sinks = [cluster.add_node(num_cpus=1) for _ in range(3)]
    cluster.connect()
    ref = art.put(_payload(6 * 1024 * 1024))
    head = cluster._node_addresses[0]
    _ensure_local(pool, n1, ref)
    threads = [threading.Thread(target=_ensure_local, args=(pool, s, ref))
               for s in sinks[:2]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    alive = any(t.is_alive() for t in threads)
    _ensure_local(pool, sinks[2], ref)
    bounded = [pool.get(h).call("GetTransferStats", {}, timeout=10)
               ["chunk_cache_bytes"] <= cache_cap for h in (head, n1)]
    cli = pool.get(n1)
    probe = {"object_id": ref.id, "offset": 0, "length": chunk,
             "stripe": True}
    cli.call("ReadChunkRaw", probe, timeout=10)
    before = cli.call("GetTransferStats", {}, timeout=10)["stripe_cache_hits"]
    cli.call("ReadChunkRaw", probe, timeout=10)
    after = cli.call("GetTransferStats", {}, timeout=10)["stripe_cache_hits"]
    return alive, bounded, after - before


def read_chunk_raw_rpc_serves_out_of_band_frames(art, cluster, pool):
    cluster.connect()
    ref = art.put(_payload(512 * 1024))
    cli = pool.get(cluster._node_addresses[0])
    legacy = cli.call("ReadChunk", {"object_id": ref.id, "offset": 0,
                                    "length": 256 * 1024}, timeout=10)
    raw = cli.call("ReadChunkRaw", {"object_id": ref.id, "offset": 0,
                                    "length": 256 * 1024}, timeout=10)
    tail = cli.call("ReadChunkRaw", {"object_id": ref.id,
                                     "offset": 512 * 1024,
                                     "length": 256 * 1024}, timeout=10)
    missing = cli.call("ReadChunkRaw",
                       {"object_id": ref.id.from_random(), "offset": 0,
                        "length": 1024}, timeout=10)
    return (bytes(raw) == bytes(legacy), len(raw), len(bytes(tail)) > 0,
            missing)


def pull_quota_serializes_oversized_bursts(art, cluster, pool):
    worker_address = cluster.add_node(num_cpus=1, labels={"role": "sink"})
    cluster.connect()
    rng = np.random.default_rng(1)
    blobs = [art.put(rng.integers(0, 256, 4 * 1024 * 1024, dtype=np.uint8))
             for _ in range(2)]

    @art.remote
    def fetch_all(refs):
        return [int(a[0]) for a in art.get(list(refs))]

    out = art.get(fetch_all.options(
        num_cpus=1, label_selector={"role": "sink"}).remote(blobs),
        timeout=120)
    stats = pool.get(worker_address).call("GetTransferStats", {},
                                          timeout=10)
    return out, stats["quota_waits"] >= 1


@pytest.mark.slow
def test_broadcast_reads_each_chunk_once():
    """The counterpart of the JAX package's test of the same name, which
    that package marks slow too (nine node daemons a cluster)."""
    want, got = _both(broadcast_reads_each_chunk_once, {
        "num_cpus": 2,
        "_system_config": {"object_transfer_chunk_size": 256 * 1024}})
    assert got == want == (True, True, True)


def test_striped_pull_two_holders_serve_disjoint_ranges():
    want, got = _both(striped_pull_two_holders_serve_disjoint_ranges, {
        "num_cpus": 1,
        "_system_config": {"object_transfer_chunk_size": 512 * 1024,
                           "object_stripe_min_bytes": 2 * 1024 * 1024}})
    assert got == want == (True, set(), True, True, True, True)


def test_striped_pull_survives_holder_death_mid_transfer():
    want, got = _both(striped_pull_survives_holder_death_mid_transfer, {
        "num_cpus": 2,
        "_system_config": {"object_transfer_chunk_size": 256 * 1024,
                           "object_stripe_min_bytes": 1024 * 1024,
                           "testing_chunk_serve_delay_s": 0.01}})
    assert got == want == (False, [], True, True, True, True)


def test_pull_window_one_is_sequential():
    want, got = _both(pull_window_one_is_sequential, {
        "num_cpus": 1,
        "_system_config": {"object_transfer_chunk_size": 256 * 1024,
                           "object_pull_window": 1}})
    assert got == want == (True, True, True)


def test_striped_pull_keeps_chunk_cache_memoized_and_bounded():
    want, got = _both(striped_pull_keeps_chunk_cache_memoized_and_bounded, {
        "num_cpus": 1,
        "_system_config": {"object_transfer_chunk_size": 256 * 1024,
                           "object_stripe_min_bytes": 1024 * 1024,
                           "transfer_chunk_cache_bytes": 1024 * 1024}})
    assert got == want == (False, [True, True], 1)


def test_read_chunk_raw_rpc_serves_out_of_band_frames():
    want, got = _both(read_chunk_raw_rpc_serves_out_of_band_frames,
                      {"num_cpus": 1})
    assert got == want == (True, 256 * 1024, True, None)


def test_pull_quota_serializes_oversized_bursts():
    want, got = _both(pull_quota_serializes_oversized_bursts, {
        "num_cpus": 2,
        "_system_config": {"pull_quota_bytes": 1024 * 1024,
                           "object_transfer_chunk_size": 128 * 1024}})
    assert got == want
    assert got[1]


def test_bf16_noncontiguous_tensor_crosses_nodes_bitwise():
    """A bf16 CPU tensor that is a non-contiguous view, put on the head
    node, is read by a task pinned to the other node (its daemon pulls
    the object): the task sees the same elements bit for bit, and the
    tensor it returns comes back bitwise too."""
    from ant_ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1})
    sink = cluster.add_node(num_cpus=1, labels={"role": "sink"})
    cluster.connect()
    try:
        gen = torch.Generator().manual_seed(0)
        base = torch.randn(512, 1024, generator=gen).to(torch.bfloat16)
        view = base[::2, 1::3]                 # 256 x 341, strided
        assert not view.is_contiguous()
        ref = tart.put(view)

        @tart.remote
        def where_and_what(t):
            from ant_ray_tpu_torch._private.worker import global_worker

            return (global_worker.runtime.node_address, t.dtype,
                    tuple(t.shape), t.view(torch.int16).clone(), t * 1)

        node, dtype, shape, bits, back = tart.get(where_and_what.options(
            num_cpus=1, label_selector={"role": "sink"}).remote(ref),
            timeout=120)
        assert node == sink
        assert (dtype, shape) == (torch.bfloat16, (256, 341))
        assert torch.equal(bits, view.contiguous().view(torch.int16))
        assert torch.equal(back.view(torch.int16),
                           view.contiguous().view(torch.int16))
    finally:
        tart.shutdown()
        cluster.shutdown()


def test_killed_node_leaves_no_arena_behind():
    """A node killed outright cannot destroy its store: the cluster
    removes its arena directory once the node is gone, and every other
    one and the session directory at shutdown."""
    import os

    from ant_ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1})
    try:
        victim = cluster.add_node(num_cpus=1)
        stores = list(cluster._store_dirs)
        assert len(stores) == 2 and all(os.path.isdir(d) for d in stores)
        cluster.remove_node(victim)
        assert not os.path.exists(stores[1]) and os.path.isdir(stores[0])
    finally:
        cluster.shutdown()
    assert not any(os.path.exists(d) for d in stores)
    assert not os.path.exists(cluster._session_dir)
