"""Logical plan + optimizer.

The reference splits Dataset into a logical operator DAG, an optimizer
(fusion), and a physical streaming topology (ref:
python/ray/data/_internal/logical/ + execution/streaming_executor.py).
Here the plan is a linear chain (datasets are linear pipelines; joins
arrive as Zip/Union sources), the optimizer fuses runs of one-to-one
row transforms into a single task per block, and executor.py streams
blocks through the fused stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


# One-to-one row/batch transforms — candidates for fusion.
@dataclass(frozen=True)
class MapRows:
    fn: Callable

@dataclass(frozen=True)
class FilterRows:
    fn: Callable

@dataclass(frozen=True)
class FlatMapRows:
    fn: Callable

@dataclass(frozen=True)
class MapBatches:
    fn: Callable
    batch_size: int | None
    batch_format: str


# All-to-all barriers.
@dataclass(frozen=True)
class Repartition:
    num_blocks: int

@dataclass(frozen=True)
class RandomShuffle:
    seed: int | None
    num_blocks: int | None = None

@dataclass(frozen=True)
class Sort:
    key: Any
    descending: bool = False

@dataclass(frozen=True)
class GroupByAggregate:
    key: Any
    aggs: tuple          # of aggregate.AggregateFn


# Misc.
@dataclass(frozen=True)
class Limit:
    n: int


@dataclass(frozen=True)
class FusedMap:
    """Optimizer output: a run of one-to-one ops as one block fn."""

    fns: tuple  # of (kind, op) pairs

    def __call__(self, block):
        from ant_ray_tpu_torch.data import block as B  # noqa: PLC0415

        for kind, op in self.fns:
            if kind == "map":
                block = B.map_rows(block, op.fn)
            elif kind == "filter":
                block = B.filter_rows(block, op.fn)
            elif kind == "flat_map":
                block = B.flat_map_rows(block, op.fn)
            elif kind == "map_batches":
                block = _apply_map_batches(block, op)
            else:  # pragma: no cover
                raise ValueError(kind)
        return block


def _apply_map_batches(block, op: MapBatches):
    from ant_ray_tpu_torch.data import block as B  # noqa: PLC0415

    accessor = B.BlockAccessor.for_block(block)
    n = accessor.num_rows()
    size = op.batch_size or max(n, 1)
    pieces = []
    for start in range(0, max(n, 1), size):
        piece = accessor.slice(start, min(start + size, n))
        batch = B.BlockAccessor.for_block(piece).to_batch(op.batch_format)
        out = op.fn(batch)
        pieces.append(B.BlockAccessor.batch_to_block(out))
        if n == 0:
            break
    return B.concat_blocks(pieces)


_ONE_TO_ONE = {MapRows: "map", FilterRows: "filter",
               FlatMapRows: "flat_map", MapBatches: "map_batches"}


def optimize(operators: tuple) -> tuple:
    """Fuse adjacent one-to-one operators (the reference's
    OperatorFusionRule)."""
    fused: list = []
    run: list = []
    for op in operators:
        kind = _ONE_TO_ONE.get(type(op))
        if kind is not None:
            run.append((kind, op))
            continue
        if run:
            fused.append(FusedMap(tuple(run)))
            run = []
        fused.append(op)
    if run:
        fused.append(FusedMap(tuple(run)))
    return tuple(fused)
