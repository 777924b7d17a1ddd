"""Streaming datasets (ref capability: ray.data — logical plan with
operator fusion, Arrow/list blocks, pull-based streaming execution,
map-reduce shuffles, datasources); the port of ant_ray_tpu.data.

No module here imports torch but ``device_feed``, which loads it when a
device feed starts.  List blocks need no pyarrow; Arrow blocks, the
tabular readers, ``from_arrow`` and ``from_pandas`` do."""

from ant_ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Sum
from ant_ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range_,
    read_csv,
    read_datasource,
    read_jsonl,
    read_parquet,
)
from ant_ray_tpu_torch.data.datasource import Datasource, ReadTask
from ant_ray_tpu_torch.data.iterator import DataIterator

range = range_  # noqa: A001 — mirrors ray.data.range

__all__ = [
    "Count",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "Max",
    "Mean",
    "Min",
    "ReadTask",
    "Sum",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_csv",
    "read_datasource",
    "read_jsonl",
    "read_parquet",
]
