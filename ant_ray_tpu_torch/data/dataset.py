"""Dataset: the public handle over a logical plan (counterpart of
ant_ray_tpu/data/dataset.py, which the port does not import).

Architecture (mirror of the reference, SURVEY §2.4 Data): a Dataset is
(source, logical operator chain).  Transforms append logical operators
(logical.py); consumption optimizes the chain (one-to-one runs fuse
into one task per block) and streams block refs through the pull-based
executor (executor.py) with bounded in-flight tasks, so datasets larger
than memory flow.  Blocks are list or Arrow blocks (block.py);
all-to-all ops (shuffle / sort / groupby / repartition) run as
map-reduce task graphs, never materializing in the driver.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator

from ant_ray_tpu_torch.data import aggregate as agg
from ant_ray_tpu_torch.data import logical as L
from ant_ray_tpu_torch.data.block import BlockAccessor
from ant_ray_tpu_torch.data.datasource import (
    CSVDatasource,
    Datasource,
    JSONLDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    write_jsonl_block,
    write_parquet_block,
)
from ant_ray_tpu_torch.data.executor import DEFAULT_IN_FLIGHT, execute

DEFAULT_PARALLELISM = 8


def _art():
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    return art


def _run_read_task(task: ReadTask):
    return task.fn()


def _block_schema(block):
    return None if isinstance(block, list) else block.schema


class Dataset:
    def __init__(self, block_refs: list | None = None,
                 operators: tuple = (),
                 read_tasks: list | None = None):
        self._block_refs = list(block_refs or [])
        self._read_tasks = list(read_tasks or [])
        self._operators = tuple(operators)

    # ---------------------------------------------------------- source

    def _source(self) -> Iterator:
        """Iterator of input block refs; read tasks launch lazily with
        the executor's window providing backpressure."""
        if self._read_tasks:
            art = _art()
            run_read = art.remote(_run_read_task)
            for task in self._read_tasks:
                yield run_read.remote(task)
        yield from self._block_refs

    def _with(self, op) -> "Dataset":
        return Dataset(self._block_refs, self._operators + (op,),
                       self._read_tasks)

    # ------------------------------------------------------- transforms

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._with(L.MapRows(fn))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return self._with(L.FilterRows(fn))

    def flat_map(self, fn: Callable[[Any], Iterable]) -> "Dataset":
        return self._with(L.FlatMapRows(fn))

    def map_batches(self, fn: Callable, batch_size: int | None = None,
                    batch_format: str = "default") -> "Dataset":
        return self._with(L.MapBatches(fn, batch_size, batch_format))

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(n))

    # ------------------------------------------------------- all-to-all

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(L.Repartition(num_blocks))

    def random_shuffle(self, seed: int | None = None) -> "Dataset":
        return self._with(L.RandomShuffle(seed))

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        return self._with(L.Sort(key, descending))

    def groupby(self, key) -> "GroupedData":
        return GroupedData(self, key)

    # ---------------------------------------------------- set operations

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (each side materializes its own plan)."""
        datasets = (self,) + others
        refs: list = []
        for ds in datasets:
            refs.extend(ds.materialize()._block_refs)
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned zip into (row_a, row_b) tuples."""
        a = self.take_all()
        b = other.take_all()
        if len(a) != len(b):
            raise ValueError(
                f"zip needs equal row counts, got {len(a)} vs {len(b)}")
        return from_items(list(builtins.zip(a, b)))

    # -------------------------------------------------------- execution

    def _iter_result_refs(self, in_flight: int = DEFAULT_IN_FLIGHT
                          ) -> Iterator:
        return execute(self._source, self._operators, in_flight)

    def _iter_result_blocks(self, in_flight: int = DEFAULT_IN_FLIGHT
                            ) -> Iterator:
        art = _art()
        for ref in self._iter_result_refs(in_flight):
            yield art.get(ref)

    def materialize(self) -> "Dataset":
        """Execute the plan; returns an operator-free Dataset over the
        result blocks (held by refs, not driver memory)."""
        if not self._operators and not self._read_tasks:
            return self
        return Dataset(list(self._iter_result_refs()))

    # ------------------------------------------------------- consumption

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_result_blocks():
            yield from BlockAccessor.for_block(block).to_rows()

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "default",
                     drop_last: bool = False) -> Iterator:
        """Stream batches; for Arrow blocks with batch_format="numpy"
        this is the device feed's path (dict of numpy columns →
        torch.from_numpy).  Batches assemble by block slice + concat, never
        round-tripping rows through Python, so Arrow dtypes survive."""
        from ant_ray_tpu_torch.data.block import batches_from_blocks  # noqa: PLC0415

        yield from batches_from_blocks(self._iter_result_blocks(),
                                       batch_size, batch_format, drop_last)

    def take(self, n: int = 20) -> list:
        out: list = []
        for block in self.limit(n)._iter_result_blocks():
            out.extend(BlockAccessor.for_block(block).to_rows())
            if len(out) >= n:
                return out[:n]
        return out

    def take_all(self) -> list:
        return [row for block in self._iter_result_blocks()
                for row in BlockAccessor.for_block(block).to_rows()]

    def count(self) -> int:
        from ant_ray_tpu_torch.data.executor import _block_rows  # noqa: PLC0415

        art = _art()
        rows_remote = art.remote(_block_rows)
        refs = [rows_remote.remote(r) for r in self._iter_result_refs()]
        return sum(art.get(refs))

    def aggregate(self, *aggs: agg.AggregateFn) -> dict:
        """Global aggregation (single implicit group)."""
        grouped = self.groupby(lambda _row: 0)._aggregate(*aggs)
        rows = grouped.take_all()
        if not rows:
            return {a.name: a.finalize(a.init()) for a in aggs}
        row = dict(rows[0])
        row.pop("key", None)
        return row

    def schema(self):
        """Schema of the first block (Arrow) or None — only the schema
        crosses the wire; the block itself stays in the cluster."""
        art = _art()
        schema_remote = art.remote(_block_schema)
        for ref in self._iter_result_refs(in_flight=1):
            return art.get(schema_remote.remote(ref))
        return None

    # -------------------------------------------------------- reshaping

    def split(self, n: int) -> list["Dataset"]:
        """Split into n datasets block-wise (for per-worker shards)."""
        ds = self.materialize()
        shards: list[list] = [[] for _ in builtins.range(n)]
        for i, ref in enumerate(ds._block_refs):
            shards[i % n].append(ref)
        return [Dataset(refs) for refs in shards]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None, name: str = ""):
        """n coordinated streaming iterators over ONE execution of the
        plan per epoch — nothing materializes (ref: dataset.py:1881).
        ``equal=True`` gives every iterator exactly the same row count
        per epoch (what SPMD training needs).  All n iterators must be
        consumed together: each epoch starts at a barrier."""
        from ant_ray_tpu_torch.data.iterator import make_streaming_split  # noqa: PLC0415

        del locality_hints  # single-store-per-node runtime: no-op hint
        return make_streaming_split(self, n, equal=equal, name=name)

    def iterator(self):
        """Single-consumer DataIterator over the plan (one execution
        per pass — ref: Dataset.iterator())."""
        from ant_ray_tpu_torch.data.iterator import PlanIterator  # noqa: PLC0415

        return PlanIterator(self)

    # ---------------------------------------------------------- writers

    def write_jsonl(self, directory: str) -> list[str]:
        return self._write(directory, "jsonl", write_jsonl_block)

    def write_parquet(self, directory: str) -> list[str]:
        return self._write(directory, "parquet", write_parquet_block)

    def _write(self, directory: str, ext: str, writer) -> list[str]:
        import os  # noqa: PLC0415

        os.makedirs(directory, exist_ok=True)
        art = _art()
        write_remote = art.remote(writer)
        refs = []
        for i, ref in enumerate(self._iter_result_refs()):
            path = os.path.join(directory, f"part-{i:05d}.{ext}")
            refs.append(write_remote.remote(ref, path))
        return art.get(refs)

    # ------------------------------------------------------------- info

    @property
    def num_blocks(self) -> int:
        if self._read_tasks:
            return len(self._read_tasks) + len(self._block_refs)
        return len(self._block_refs)

    def __repr__(self):
        return (f"Dataset(num_blocks={self.num_blocks}, "
                f"pending_operators={len(self._operators)})")


class GroupedData:
    """(ref: python/ray/data/grouped_data.py)"""

    def __init__(self, dataset: Dataset, key):
        self._dataset = dataset
        self._key = key

    def _aggregate(self, *aggs: agg.AggregateFn) -> Dataset:
        return self._dataset._with(
            L.GroupByAggregate(self._key, tuple(aggs)))

    def aggregate(self, *aggs: agg.AggregateFn) -> Dataset:
        return self._aggregate(*aggs)

    def count(self) -> Dataset:
        return self._aggregate(agg.Count())

    def sum(self, on=None) -> Dataset:
        return self._aggregate(agg.Sum(on))

    def min(self, on=None) -> Dataset:
        return self._aggregate(agg.Min(on))

    def max(self, on=None) -> Dataset:
        return self._aggregate(agg.Max(on))

    def mean(self, on=None) -> Dataset:
        return self._aggregate(agg.Mean(on))


# ------------------------------------------------------------ constructors

def from_items(items: list, parallelism: int = DEFAULT_PARALLELISM
               ) -> Dataset:
    art = _art()
    items = list(items)
    if not items:
        return Dataset([art.put([])])
    parallelism = max(1, min(parallelism, len(items)))
    size = (len(items) + parallelism - 1) // parallelism
    refs = [art.put(items[i:i + size])
            for i in builtins.range(0, len(items), size)]
    return Dataset(refs)


def range_(n: int, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(RangeDatasource(n), parallelism)


def from_numpy(array, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return from_items(list(array), parallelism)


def from_arrow(table) -> Dataset:
    art = _art()
    return Dataset([art.put(table)])


def from_pandas(df) -> Dataset:
    import pyarrow  # noqa: PLC0415

    return from_arrow(pyarrow.Table.from_pandas(df))


def read_datasource(source: Datasource,
                    parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return Dataset(read_tasks=source.get_read_tasks(parallelism))


def read_csv(paths, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(CSVDatasource(paths), parallelism)


def read_jsonl(paths, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(JSONLDatasource(paths), parallelism)


def read_parquet(paths, parallelism: int = DEFAULT_PARALLELISM) -> Dataset:
    return read_datasource(ParquetDatasource(paths), parallelism)
