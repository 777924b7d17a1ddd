"""Block model: the unit of data movement (counterpart of
ant_ray_tpu/data/block.py, which the port does not import).

Two physical layouts behind one accessor interface (ref:
python/ray/data/block.py BlockAccessor — there list/Arrow/pandas, here
list and Arrow):

* **list blocks** — a plain Python list of rows (any objects).  The
  default for `from_items` / generic maps.  Nothing on their path
  imports pyarrow: every dispatch tests ``isinstance(block, list)``
  first, so list-block Data runs on a host without pyarrow.
* **Arrow blocks** — a ``pyarrow.Table``.  Tabular datasources (csv /
  json / parquet) produce these; ``map_batches(format="numpy")`` gets
  zero-copy column views, the fast path into ``torch.from_numpy`` for
  the device feed.  Asking for one without pyarrow raises an
  ``ImportError`` that names it.

Blocks live in the object store (a ``pyarrow.Table`` pickles its
buffers under protocol 5, which ride out-of-band into the arena).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np


def _pa():
    try:
        import pyarrow  # noqa: PLC0415
    except ImportError as e:
        raise ImportError(
            "Arrow blocks need pyarrow, which is not installed; list "
            "blocks (from_items, range, from_numpy) run without it") from e
    return pyarrow


def _is_arrow(block) -> bool:
    """``block`` is a ``pyarrow.Table``; without pyarrow nothing is."""
    try:
        import pyarrow  # noqa: PLC0415
    except ImportError:
        return False
    return isinstance(block, pyarrow.Table)


class BlockAccessor:
    """Uniform view over one block."""

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        if isinstance(block, list):
            return ListBlockAccessor(block)
        if _is_arrow(block):
            return ArrowBlockAccessor(block)
        raise TypeError(f"not a block: {type(block)}")

    @staticmethod
    def batch_to_block(batch) -> Any:
        """A map_batches return value → block: dict of arrays becomes an
        Arrow table, a list stays a list block."""
        if isinstance(batch, dict):
            pa = _pa()
            return pa.table({
                k: (pa.array(np.asarray(v).tolist())
                    if getattr(np.asarray(v), "ndim", 1) > 1
                    else pa.array(np.asarray(v)))
                for k, v in batch.items()})
        return list(batch)

    # ---- required surface

    def num_rows(self) -> int:
        raise NotImplementedError

    def to_rows(self) -> list:
        raise NotImplementedError

    def to_batch(self, batch_format: str = "default"):
        """"default": rows for list blocks / dict-of-numpy for Arrow.
        "numpy": dict of numpy arrays.  "rows": list of rows (dicts for
        Arrow)."""
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Any:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def sort_key_values(self, key) -> list:
        """Values used for range-partitioned sort."""
        raise NotImplementedError


class ListBlockAccessor(BlockAccessor):
    def __init__(self, block: list):
        self._block = block

    def num_rows(self) -> int:
        return len(self._block)

    def to_rows(self) -> list:
        return self._block

    def to_batch(self, batch_format: str = "default"):
        if batch_format == "numpy":
            return {"value": np.asarray(self._block)}
        return self._block

    def slice(self, start: int, end: int) -> list:
        return self._block[start:end]

    def size_bytes(self) -> int:
        import sys  # noqa: PLC0415

        return sum(sys.getsizeof(x) for x in self._block)

    def sort_key_values(self, key) -> list:
        if key is None:
            return self._block
        if callable(key):
            return [key(x) for x in self._block]
        return [x[key] for x in self._block]


class ArrowBlockAccessor(BlockAccessor):
    def __init__(self, table):
        self._table = table

    def num_rows(self) -> int:
        return self._table.num_rows

    def to_rows(self) -> list:
        return self._table.to_pylist()

    def to_batch(self, batch_format: str = "default"):
        if batch_format == "rows":
            return self._table.to_pylist()
        # default / numpy: dict of numpy column arrays (zero-copy when
        # the type allows).
        return {name: self._table.column(name).to_numpy(
                    zero_copy_only=False)
                for name in self._table.column_names}

    def slice(self, start: int, end: int):
        return self._table.slice(start, end - start)

    def size_bytes(self) -> int:
        return self._table.nbytes

    def sort_key_values(self, key) -> list:
        if callable(key):
            return [key(row) for row in self._table.to_pylist()]
        return self._table.column(key).to_pylist()


def concat_blocks(blocks: list):
    """Concatenate blocks into one.

    Same-kind inputs keep their kind.  Mixed list/Arrow inputs promote
    list blocks of dict rows to Arrow; if any list block holds non-dict
    rows (from_pylist needs mappings) everything degrades to one list
    block instead."""
    if not blocks:
        return []
    if all(isinstance(b, list) for b in blocks):
        out: list = []
        for b in blocks:
            out.extend(b)
        return out
    nonempty = [b for b in blocks if not isinstance(b, list) or b]
    if any(isinstance(b, list) and not all(isinstance(r, dict) for r in b)
           for b in nonempty):
        out = []
        for b in nonempty:
            out.extend(BlockAccessor.for_block(b).to_rows())
        return out
    pa = _pa()
    tables = [b if not isinstance(b, list) else
              pa.Table.from_pylist(b) for b in nonempty]
    if not tables:
        return []
    return pa.concat_tables(tables, promote_options="default")


def batches_from_blocks(blocks: Iterable, batch_size: int,
                        batch_format: str = "default",
                        drop_last: bool = False):
    """Re-batch a block stream into fixed-size batches.  Batches
    assemble by block slice + concat, never round-tripping rows through
    Python, so Arrow dtypes survive (this is the device feed's path:
    batch_format="numpy" → dict of numpy columns → torch.from_numpy).
    Shared by Dataset.iter_batches and every DataIterator."""
    pending: list = []     # [accessor, start offset] pieces
    pending_rows = 0
    for block in blocks:
        accessor = BlockAccessor.for_block(block)
        if accessor.num_rows() == 0:
            continue
        pending.append([accessor, 0])
        pending_rows += accessor.num_rows()
        while pending_rows >= batch_size:
            yield _assemble_batch(pending, batch_size, batch_format)
            pending_rows -= batch_size
    if pending_rows and not drop_last:
        yield _assemble_batch(pending, pending_rows, batch_format)


def _assemble_batch(pending: list, n: int, batch_format: str):
    pieces = []
    taken = 0
    while taken < n:
        accessor, start = pending[0]
        available = accessor.num_rows() - start
        use = min(available, n - taken)
        pieces.append(accessor.slice(start, start + use))
        taken += use
        if use == available:
            pending.pop(0)
        else:
            pending[0][1] = start + use
    batch_block = concat_blocks(pieces)
    if batch_format == "default" and isinstance(batch_block, list):
        return batch_block
    return BlockAccessor.for_block(batch_block).to_batch(
        "numpy" if batch_format in ("default", "numpy") else batch_format)


def rows_to_block(rows: list, like) -> Any:
    """Rebuild a block of the same kind as ``like`` from rows.

    The schema is inferred from the rows (a map may change columns
    entirely); ``like``'s schema is only kept for empty row lists,
    where there is nothing to infer from."""
    if isinstance(like, list):
        return list(rows)
    if _is_arrow(like):
        if not rows:
            return like.schema.empty_table()
        return _pa().Table.from_pylist(rows)
    return list(rows)


def map_rows(block, fn: Callable[[Any], Any]):
    """Apply a per-row fn; list blocks stay lists (fn may change row
    type arbitrarily), Arrow blocks rebuild from dict rows when the fn
    returns dicts, else degrade to a list block."""
    accessor = BlockAccessor.for_block(block)
    rows = [fn(row) for row in accessor.to_rows()]
    if not isinstance(block, list) and rows and \
            all(isinstance(r, dict) for r in rows):
        return rows_to_block(rows, block)
    return rows


def filter_rows(block, fn: Callable[[Any], bool]):
    if isinstance(block, list):
        return [x for x in block if fn(x)]
    if _is_arrow(block):
        mask = [bool(fn(row)) for row in block.to_pylist()]
        return block.filter(_pa().array(mask))
    return [x for x in block if fn(x)]


def flat_map_rows(block, fn: Callable[[Any], Iterable]):
    accessor = BlockAccessor.for_block(block)
    rows = [y for x in accessor.to_rows() for y in fn(x)]
    if not isinstance(block, list) and rows and \
            all(isinstance(r, dict) for r in rows):
        return rows_to_block(rows, block)
    return rows
