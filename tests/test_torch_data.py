"""The port's Data (ant_ray_tpu_torch/data/) against the JAX package's:
each scenario of tests/test_data.py runs through both packages, each in
its own cluster (started without ``_system_config``: both packages read
the same ``ART_*`` variables), and keeps the reference's assertions;
the two outcomes must then be equal — rows in order where the reference
fixes an order (sorts, limits, zips, seeded shuffles: both packages
derive their shuffle streams from the same stable hash of the seed),
as sorted lists where it does not, and block counts, schemas and batch
shapes.

Left out: ``test_state_api`` (its ``util/state.py`` comes with ROADMAP
queue A item 6.6)."""

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.data as jdata
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.data as tdata


@pytest.fixture(scope="module")
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


PACKAGES = ((jart, jdata), (tart, tdata))


def _both(scenario):
    """``scenario(art, data)`` through the JAX package, then the port;
    returns (want, got)."""
    return tuple(scenario(art, data) for art, data in PACKAGES)


def test_exported_surface_matches_jax():
    assert tdata.__all__ == jdata.__all__
    assert tdata.range is tdata.range_
    for name in ("Count", "Sum", "Min", "Max", "Mean"):
        want = getattr(jdata, name)() if name == "Count" else \
            getattr(jdata, name)("v")
        got = getattr(tdata, name)() if name == "Count" else \
            getattr(tdata, name)("v")
        assert (got.name, got.on) == (want.name, want.on)


def test_from_items_and_count(clusters):
    def scenario(art, data):
        ds = data.from_items(list(range(100)), parallelism=4)
        return ds.num_blocks, ds.count()

    want, got = _both(scenario)
    assert got == want == (4, 100)


def test_map_filter_chain(clusters):
    def scenario(art, data):
        ds = data.range(50).map(lambda x: x * 2).filter(
            lambda x: x % 10 == 0)
        return sorted(ds.take_all())

    want, got = _both(scenario)
    assert got == want == [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]


def test_flat_map(clusters):
    def scenario(art, data):
        return sorted(data.from_items([1, 2, 3]).flat_map(
            lambda x: [x] * x).take_all())

    want, got = _both(scenario)
    assert got == want == [1, 2, 2, 3, 3, 3]


def test_map_batches(clusters):
    def scenario(art, data):
        return data.range(32, parallelism=2).map_batches(
            lambda batch: [sum(batch)], batch_size=8).take_all()

    want, got = _both(scenario)
    assert got == want
    assert sum(got) == sum(range(32)) and len(got) == 4


def test_iter_batches_streaming(clusters):
    def scenario(art, data):
        ds = data.range(100, parallelism=10).map(lambda x: x + 1)
        return [list(b) for b in ds.iter_batches(batch_size=30)]

    want, got = _both(scenario)
    assert got == want
    assert sorted(x for b in got for x in b) == list(range(1, 101))
    assert max(len(b) for b in got) == 30


def test_take(clusters):
    want, got = _both(lambda art, data: data.range(1000).take(5))
    assert got == want and len(got) == 5


def test_split_for_workers(clusters):
    def scenario(art, data):
        shards = data.range(100, parallelism=8).split(4)
        return [sorted(s.take_all()) for s in shards]

    want, got = _both(scenario)
    assert got == want and len(got) == 4
    assert sorted(x for s in got for x in s) == list(range(100))


def test_random_shuffle(clusters):
    base = list(range(64))

    def scenario(art, data):
        return data.from_items(base).random_shuffle(seed=42).take_all()

    want, got = _both(scenario)
    assert got == want
    assert sorted(got) == base and got != base


def test_materialize_executes_once(clusters):
    def scenario(art, data):
        ds = data.range(16, parallelism=2).map(lambda x: x * 3) \
            .materialize()
        return ds._operators, sorted(ds.take_all())

    want, got = _both(scenario)
    assert got == want == ((), [x * 3 for x in range(16)])


# ---------------------------------------------------- blocks & datasources


def test_read_jsonl_roundtrip(clusters, tmp_path):
    rows = [{"x": i, "y": f"s{i}"} for i in range(20)]

    def scenario(art, data):
        out = tmp_path / art.__name__ / "out"
        paths = data.from_items(rows).write_jsonl(str(out))
        back = data.read_jsonl(str(out))
        return len(paths), sorted(back.take_all(), key=lambda r: r["x"])

    want, got = _both(scenario)
    assert got == want
    assert got[0] >= 1 and got[1] == rows


def test_read_parquet_and_csv(clusters, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from pyarrow import csv as pacsv

    table = pa.table({"a": list(range(10)),
                      "b": [i * 2.5 for i in range(10)]})
    pq.write_table(table, str(tmp_path / "t.parquet"))
    pacsv.write_csv(table, str(tmp_path / "t.csv"))

    def scenario(art, data):
        ds_pq = data.read_parquet(str(tmp_path / "t.parquet"))
        ds_csv = data.read_csv(str(tmp_path / "t.csv"))
        return (ds_pq.count(), ds_pq.schema().names,
                sorted(ds_csv.take_all(), key=lambda r: r["a"]))

    want, got = _both(scenario)
    assert got == want
    assert got[0] == 10 and got[1] == ["a", "b"]
    assert got[2][3] == {"a": 3, "b": 7.5}


def test_map_batches_numpy_format_on_arrow(clusters):
    import pyarrow as pa

    table = pa.table({"x": np.arange(32, dtype=np.int64)})

    def scenario(art, data):
        out = data.from_arrow(table).map_batches(
            lambda batch: {"x2": batch["x"] * 2},
            batch_format="numpy").take_all()
        return sorted(r["x2"] for r in out)

    want, got = _both(scenario)
    assert got == want == [2 * i for i in range(32)]


def test_sort_distributed(clusters):
    import random

    values = list(range(100))
    random.Random(0).shuffle(values)

    def scenario(art, data):
        return (data.from_items(values, parallelism=8).sort().take_all(),
                data.from_items(values, parallelism=4).sort(
                    descending=True).take_all())

    want, got = _both(scenario)
    assert got == want
    assert got == (sorted(values), sorted(values, reverse=True))


def test_sort_by_column_key(clusters):
    rows = [{"k": i % 7, "v": i} for i in range(30)]

    def scenario(art, data):
        out = data.from_items(rows, parallelism=4).sort(key="k").take_all()
        return [r["k"] for r in out]

    want, got = _both(scenario)
    assert got == want == sorted(r["k"] for r in rows)


def test_groupby_aggregates(clusters):
    rows = [{"g": i % 3, "v": i} for i in range(30)]

    def scenario(art, data):
        out = data.from_items(rows, parallelism=4).groupby("g").aggregate(
            data.Count(), data.Sum(on="v"), data.Mean(on="v")).take_all()
        return sorted(out, key=lambda r: r["g"])

    want, got = _both(scenario)
    assert got == want
    by_group = {r["g"]: r for r in got}
    assert by_group[0]["count"] == 10
    assert by_group[1]["sum(v)"] == sum(i for i in range(30) if i % 3 == 1)
    assert abs(by_group[2]["mean(v)"]
               - sum(i for i in range(30) if i % 3 == 2) / 10) < 1e-9


def test_global_aggregate(clusters):
    def scenario(art, data):
        return data.range(100, parallelism=8).aggregate(
            data.Sum(), data.Min(), data.Max())

    want, got = _both(scenario)
    assert got == want == {"sum": 4950, "min": 0, "max": 99}


def test_repartition_is_distributed(clusters):
    def scenario(art, data):
        ds = data.range(64, parallelism=2).repartition(8).materialize()
        return ds.num_blocks, sorted(ds.take_all())

    want, got = _both(scenario)
    assert got == want == (8, list(range(64)))


def test_limit_short_circuits(clusters):
    def scenario(art, data):
        ds = data.range(1000, parallelism=10).map(lambda x: x + 1).limit(15)
        return ds.take_all(), data.range(100).take(5)

    want, got = _both(scenario)
    assert got == want == (list(range(1, 16)), [0, 1, 2, 3, 4])


def test_union_and_zip(clusters):
    def scenario(art, data):
        a = data.from_items([1, 2, 3])
        b = data.from_items([4, 5, 6])
        return sorted(a.union(b).take_all()), a.zip(b).take_all()

    want, got = _both(scenario)
    assert got == want == ([1, 2, 3, 4, 5, 6], [(1, 4), (2, 5), (3, 6)])


def test_operator_fusion(clusters):
    def scenario(art, data):
        logical = __import__(f"{art.__name__}.data.logical",
                             fromlist=["optimize"])
        ds = data.range(8).map(lambda x: x + 1).filter(
            lambda x: x % 2 == 0).flat_map(lambda x: [x, x])
        optimized = logical.optimize(ds._operators)
        return ([type(op).__name__ for op in optimized],
                [kind for kind, _ in optimized[0].fns],
                sorted(ds.take_all()))

    want, got = _both(scenario)
    assert got == want
    assert got[0] == ["FusedMap"] and got[1] == ["map", "filter", "flat_map"]
    assert got[2] == sorted(
        [x for i in range(8) if (i + 1) % 2 == 0 for x in [i + 1, i + 1]])


def test_iter_batches_numpy_from_arrow(clusters):
    import pyarrow as pa

    table = pa.table({"x": np.arange(10, dtype=np.float32)})

    def scenario(art, data):
        batches = list(data.from_arrow(table).iter_batches(
            batch_size=4, batch_format="numpy"))
        return ([len(b["x"]) for b in batches], str(batches[0]["x"].dtype),
                np.concatenate([b["x"] for b in batches]).tolist())

    want, got = _both(scenario)
    assert got == want
    assert got[0] == [4, 4, 2] and got[1] == "float32"


def test_groupby_string_keys_across_workers(clusters):
    """String group keys must hash identically in every worker process
    (builtin hash is per-process randomized)."""
    rows = [{"g": f"key{i % 4}", "v": 1} for i in range(40)]

    def scenario(art, data):
        out = data.from_items(rows, parallelism=8).groupby("g").count() \
            .take_all()
        return sorted((r["g"], r["count"]) for r in out)

    want, got = _both(scenario)
    assert got == want == [(f"key{j}", 10) for j in range(4)]


def test_random_shuffle_breaks_runs(clusters):
    """Shuffle must permute within partitions, not just route blocks."""
    n = 512

    def scenario(art, data):
        return data.from_items(list(range(n)), parallelism=4) \
            .random_shuffle(seed=7).take_all()

    want, got = _both(scenario)
    assert got == want
    assert sorted(got) == list(range(n))
    ascending_pairs = sum(1 for a, b in zip(got, got[1:]) if b == a + 1)
    assert ascending_pairs < n // 8   # a sorted run would be ~n


def test_union_mixed_kinds_batches(clusters):
    import pyarrow as pa

    def scenario(art, data):
        mixed = data.from_items([1, 2, 3]).union(
            data.from_arrow(pa.table({"x": [1, 2]})))
        batches = list(mixed.iter_batches(batch_size=4))
        return [len(b) if isinstance(b, list) else
                len(next(iter(b.values()))) for b in batches]

    want, got = _both(scenario)
    assert got == want and sum(got) == 5
