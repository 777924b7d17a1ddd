"""Aggregations for groupby / global aggregates (ref:
python/ray/data/aggregate.py — AggregateFn with init/accumulate/merge/
finalize, the classic combiner contract)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class AggregateFn:
    name: str
    init: Callable[[], Any]
    accumulate: Callable[[Any, Any], Any]     # (acc, row_value) -> acc
    merge: Callable[[Any, Any], Any]          # (acc, acc) -> acc
    finalize: Callable[[Any], Any] = staticmethod(lambda a: a)
    on: Any = None                            # column / fn the value comes from

    def value_of(self, row):
        if self.on is None:
            return row
        if callable(self.on):
            return self.on(row)
        return row[self.on]


def Count() -> AggregateFn:
    return AggregateFn(
        name="count", init=lambda: 0,
        accumulate=lambda a, _v: a + 1,
        merge=lambda a, b: a + b)


def Sum(on=None) -> AggregateFn:
    return AggregateFn(
        name=f"sum({on})" if on is not None else "sum",
        init=lambda: 0, accumulate=lambda a, v: a + v,
        merge=lambda a, b: a + b, on=on)


def Min(on=None) -> AggregateFn:
    return AggregateFn(
        name=f"min({on})" if on is not None else "min",
        init=lambda: None,
        accumulate=lambda a, v: v if a is None else min(a, v),
        merge=lambda a, b: b if a is None else (a if b is None
                                                else min(a, b)),
        on=on)


def Max(on=None) -> AggregateFn:
    return AggregateFn(
        name=f"max({on})" if on is not None else "max",
        init=lambda: None,
        accumulate=lambda a, v: v if a is None else max(a, v),
        merge=lambda a, b: b if a is None else (a if b is None
                                                else max(a, b)),
        on=on)


def Mean(on=None) -> AggregateFn:
    return AggregateFn(
        name=f"mean({on})" if on is not None else "mean",
        init=lambda: (0, 0),
        accumulate=lambda a, v: (a[0] + v, a[1] + 1),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda a: a[0] / a[1] if a[1] else None,
        on=on)
