"""Datasources: lazy read tasks producing blocks (ref:
python/ray/data/datasource/ — Datasource.get_read_tasks; here each
ReadTask is a plain callable shipped to a worker, returning one block).

Tabular readers (csv / json-lines / parquet) produce Arrow blocks;
``read_numpy``/``from_items`` produce list blocks.  Writers are block
tasks too — write_jsonl / write_parquet fan out one file per block.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ReadTask:
    """One unit of lazy input: fn() -> block."""

    fn: Callable[[], Any]


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self._n = n

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = self._n
        parallelism = max(1, min(parallelism, n or 1))
        bounds = [round(i * n / parallelism)
                  for i in builtins.range(parallelism + 1)]

        def make(start: int, end: int) -> ReadTask:
            return ReadTask(lambda: list(builtins.range(start, end)))

        return [make(bounds[i], bounds[i + 1])
                for i in builtins.range(parallelism)]


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if not f.startswith(".")))
        elif any(c in path for c in "*?["):
            out.extend(sorted(_glob.glob(path)))
        else:
            out.append(path)
    if not out:
        raise FileNotFoundError(f"no files match {paths!r}")
    return out


class FileDatasource(Datasource):
    """One read task per file (the reference splits large files into
    row-group/byte-range tasks; per-file is the right granularity for
    the block sizes this engine targets)."""

    def __init__(self, paths):
        self._paths = _expand_paths(paths)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        read_file = type(self)._read_file
        return [ReadTask(lambda p=path: read_file(p))
                for path in self._paths]

    @staticmethod
    def _read_file(path: str):  # pragma: no cover — abstract
        raise NotImplementedError


class _ArrowFileDatasource(FileDatasource):
    """Tabular readers produce Arrow blocks, so they need pyarrow:
    checked where the dataset is made, before any read task runs."""

    def __init__(self, paths):
        from ant_ray_tpu_torch.data.block import _pa  # noqa: PLC0415

        _pa()
        super().__init__(paths)


class CSVDatasource(_ArrowFileDatasource):
    @staticmethod
    def _read_file(path: str):
        from pyarrow import csv  # noqa: PLC0415

        return csv.read_csv(path)


class JSONLDatasource(_ArrowFileDatasource):
    @staticmethod
    def _read_file(path: str):
        import json as _json  # noqa: PLC0415

        import pyarrow  # noqa: PLC0415

        with open(path) as f:
            rows = [_json.loads(line) for line in f if line.strip()]
        return pyarrow.Table.from_pylist(rows)


class ParquetDatasource(_ArrowFileDatasource):
    @staticmethod
    def _read_file(path: str):
        import pyarrow.parquet as pq  # noqa: PLC0415

        return pq.read_table(path)


# --------------------------------------------------------------- writers

def write_jsonl_block(block, path: str) -> str:
    import json as _json  # noqa: PLC0415

    from ant_ray_tpu_torch.data.block import BlockAccessor  # noqa: PLC0415

    rows = BlockAccessor.for_block(block).to_rows()
    with open(path, "w") as f:
        for row in rows:
            f.write(_json.dumps(row) + "\n")
    return path


def write_parquet_block(block, path: str) -> str:
    import pyarrow  # noqa: PLC0415
    import pyarrow.parquet as pq  # noqa: PLC0415

    if isinstance(block, list):
        block = pyarrow.Table.from_pylist(block)
    pq.write_table(block, path)
    return path
