"""The port's streaming Data executor and streaming split against the
JAX package's: the scenarios of tests/test_data_streaming.py (the two
that sort or repartition several times the store's capacity are marked
slow there and here) and the four ``streaming_split`` scenarios of
tests/test_train_data.py, which need no trainer.  Each runs through
both packages, each in its own cluster, keeps the reference's
assertions, and the outcomes must be equal: with ``equal=True`` the
rows each consumer got (the dispatch does not depend on the consumers'
timing), with ``equal=False`` the partition's properties."""

import threading
import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.data as jdata
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.data as tdata
from ant_ray_tpu._private import config as jconfig
from ant_ray_tpu._private.protocol import ClientPool as JClientPool
from ant_ray_tpu_torch._private import config as tconfig
from ant_ray_tpu_torch._private.protocol import ClientPool as TClientPool

PACKAGES = ((jart, jdata, jconfig, JClientPool),
            (tart, tdata, tconfig, TClientPool))

STORE_CAP = 24 * 1024 * 1024          # 24 MiB store


def _in_clusters(scenario, env=None, num_cpus=2, monkeypatch=None):
    """``scenario(art, data, ClientPool)`` in a fresh cluster of each
    package in turn (``env``: ``ART_*`` variables both read at init);
    returns (want, got)."""
    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    outs = []
    for art, data, config_mod, pool in PACKAGES:
        config_mod._global_config = None
        art.init(num_cpus=num_cpus)
        try:
            outs.append(scenario(art, data, pool))
        finally:
            art.shutdown()
            config_mod._global_config = None
    return tuple(outs)


@pytest.fixture()
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _both(scenario):
    return tuple(scenario(art, data) for art, data, _, _ in PACKAGES)


# ------------------------------------------ tests/test_data_streaming.py


def _watch_store(art, pool):
    """A thread sampling the local store's use; returns (peak, stop)."""
    runtime = art.api.global_worker.runtime
    node = pool().get(runtime.node_address)
    peak = {"used": 0}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            try:
                stats = node.call("GetStoreStats", {}, timeout=5)
                peak["used"] = max(peak["used"], stats["used"])
            except Exception:  # noqa: BLE001
                break
            time.sleep(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return peak, stop, watcher


@pytest.mark.slow
def test_sort_dataset_4x_store_cap(monkeypatch):
    n_blocks = 48
    rows_per_block = 256
    payload = 8 * 1024                # ~2 MiB/block -> ~96 MiB total

    def gen(i):
        rng = np.random.default_rng(i)
        return [{"k": int(rng.integers(0, 1 << 30)),
                 "pad": bytes(payload)} for _ in range(rows_per_block)]

    items = []
    for i in range(n_blocks):
        items.extend(gen(i))

    def scenario(art, data, pool):
        ds = data.from_items(items, parallelism=n_blocks)
        peak, stop, watcher = _watch_store(art, pool)
        try:
            keys = [row["k"] for batch in ds.sort(key="k").iter_batches(
                batch_size=1024) for row in batch]
        finally:
            stop.set()
            watcher.join(timeout=5)
        return (keys, 0 < peak["used"] <= STORE_CAP)

    want, got = _in_clusters(
        scenario, {"ART_OBJECT_STORE_MEMORY": str(STORE_CAP)},
        monkeypatch=monkeypatch)
    assert got == want
    assert got[0] == sorted(row["k"] for row in items)
    assert got[1], "store exceeded its cap (or the watchdog never sampled)"


@pytest.mark.slow
def test_repartition_dataset_3x_store_cap(monkeypatch):
    n_blocks = 36
    rows_per_block = 64
    payload = 32 * 1024               # ~2 MiB/block -> ~72 MiB total
    items = [{"i": b * rows_per_block + r, "pad": bytes(payload)}
             for b in range(n_blocks) for r in range(rows_per_block)]

    def scenario(art, data, pool):
        ds = data.from_items(items, parallelism=n_blocks)
        return sorted(row["i"] for batch in ds.repartition(12).iter_batches(
            batch_size=512) for row in batch)

    want, got = _in_clusters(
        scenario, {"ART_OBJECT_STORE_MEMORY": str(STORE_CAP)},
        monkeypatch=monkeypatch)
    assert got == want == list(range(n_blocks * rows_per_block))


def test_object_sizes_api(monkeypatch):
    """Driver-side best-effort block sizes (feeds the byte-budget
    backpressure): inline and plasma entries answer; pending is None."""
    def scenario(art, data, pool):
        runtime = art.api.global_worker.runtime
        small = art.put({"k": 1})
        big = art.put(np.zeros(1_000_000, dtype=np.uint8))

        @art.remote
        def never_mind():
            time.sleep(30)
            return 1

        pending = never_mind.remote()
        sizes = runtime.object_sizes([small, big, pending])
        art.cancel(pending)
        return (sizes[0] is not None and sizes[0] > 0,
                sizes[1] is not None and sizes[1] >= 1_000_000,
                sizes[2] is None)

    want, got = _in_clusters(scenario, num_cpus=1, monkeypatch=monkeypatch)
    assert got == want == (True, True, True)


def test_sort_first_partition_before_full_merge(monkeypatch):
    """Lazy merge phase: the first sorted partition is yielded while the
    stream is still open (merges launch on downstream demand with a
    small lookahead).  A tiny target block size (the
    ``data_target_block_bytes`` flag, read from ``ART_*``) forces many
    partitions despite the small dataset."""
    rows = [{"k": (i * 37) % 500} for i in range(400)]

    def scenario(art, data, pool):
        block = __import__(f"{art.__name__}.data.block",
                           fromlist=["BlockAccessor"])
        ds = data.from_items(rows, parallelism=8)
        stream = ds.sort(key="k")._iter_result_refs()
        first = block.BlockAccessor.for_block(
            art.get(next(stream))).to_rows()
        vals = [r["k"] for r in first]
        rest = [r["k"] for ref in stream for r in
                block.BlockAccessor.for_block(art.get(ref)).to_rows()]
        return (vals == sorted(vals), len(rest) >= 1,
                vals + rest == sorted(r["k"] for r in rows))

    want, got = _in_clusters(
        scenario, {"ART_DATA_TARGET_BLOCK_BYTES": "512"},
        monkeypatch=monkeypatch)
    assert got == want == (True, True, True)


# ------------------------- streaming_split (tests/test_train_data.py)


def _consume_all(iterators, epochs=1, batch_size=16):
    """Drive n coordinated iterators concurrently (the barrier needs
    all of them); returns per-iterator per-epoch row lists."""
    out = [[[] for _ in range(epochs)] for _ in iterators]
    errors = []

    def run(i, it):
        try:
            for e in range(epochs):
                for batch in it.iter_batches(batch_size=batch_size,
                                             batch_format="rows"):
                    out[i][e].extend(batch)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, it))
               for i, it in enumerate(iterators)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "consumer hung"
    if errors:
        raise errors[0]
    return out


def test_streaming_split_partitions_without_materializing(clusters):
    def scenario(art, data):
        out = _consume_all(data.range(100, parallelism=8).streaming_split(
            2, equal=False))
        rows_a, rows_b = set(out[0][0]), set(out[1][0])
        return (rows_a | rows_b == set(range(100)), not (rows_a & rows_b),
                bool(rows_a) and bool(rows_b))

    want, got = _both(scenario)
    assert got == want == (True, True, True)


def test_streaming_split_equal_exact_row_counts(clusters):
    # 103 rows over 7 blocks across 3 splits: equal=True must hand every
    # split exactly floor-min rows, no deadlocked short rank.
    def scenario(art, data):
        out = _consume_all(data.range(103, parallelism=7).streaming_split(
            3, equal=True))
        return [sorted(out[i][0]) for i in range(3)]

    want, got = _both(scenario)
    assert got == want
    counts = [len(rows) for rows in got]
    assert counts[0] == counts[1] == counts[2] > 0
    all_rows = [r for rows in got for r in rows]
    assert len(all_rows) == len(set(all_rows))  # no duplication


def test_streaming_split_equal_more_splits_than_blocks(clusters):
    # 1 block, 4 splits: tail blocks must subdivide so nobody starves.
    def scenario(art, data):
        ds = data.from_items([{"id": i} for i in range(20)], parallelism=1)
        out = _consume_all(ds.streaming_split(4, equal=True))
        return [sorted(r["id"] for r in out[i][0]) for i in range(4)]

    want, got = _both(scenario)
    assert got == want
    assert [len(rows) for rows in got] == [5, 5, 5, 5]


def test_streaming_split_coordinated_epochs(clusters):
    def scenario(art, data):
        its = data.range(40, parallelism=4).streaming_split(2, equal=True)
        out = _consume_all(its, epochs=3)
        return ([{r for i in range(2) for r in out[i][e]} == set(range(40))
                 for e in range(3)], its[0].stats()["epochs_finished"])

    want, got = _both(scenario)
    assert got == want == ([True] * 3, 3)
