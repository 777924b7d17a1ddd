"""Offline RL data pipeline over the Data engine (ref:
python/ray/rllib/offline/offline_data.py:29 — OfflineData streams
recorded experience from datasets into learners instead of sampling an
environment); the JAX package's ``rllib/offline.py`` over the port's
``data``.

``OfflineData`` wraps an ``ant_ray_tpu_torch.data.Dataset`` (or reads one
from parquet/jsonl paths) and yields numpy transition minibatches
through the streaming executor — datasets larger than memory flow with
bounded footprint, and a per-epoch ``random_shuffle`` rides the
engine's map-reduce shuffle."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _column_to_array(values) -> np.ndarray:
    """Arrow list columns surface as object arrays of lists — stack
    them into a dense (n, d) float array; scalars pass through."""
    arr = np.asarray(values)
    if arr.dtype == object:
        return np.stack([np.asarray(v) for v in values])
    return arr


class OfflineData:
    """Streaming source of transition minibatches.

    ``source``: a data.Dataset, or path(s) to parquet/jsonl files of
    transition rows (e.g. {"obs": [...], "actions": i, ...}).
    """

    def __init__(self, source, *, shuffle: bool = True,
                 shuffle_seed: int | None = None):
        from ant_ray_tpu_torch import data  # noqa: PLC0415

        if isinstance(source, (str, list)) and not isinstance(
                source, data.Dataset):
            paths = [source] if isinstance(source, str) else list(source)
            if all(str(p).endswith(".jsonl") for p in paths):
                source = data.read_jsonl(paths)
            else:
                source = data.read_parquet(paths)
        self._ds = source
        self._shuffle = shuffle
        self._seed = shuffle_seed

    @property
    def dataset(self):
        return self._ds

    def iter_minibatches(self, batch_size: int = 128, *,
                         columns: tuple = ("obs", "actions"),
                         drop_last: bool = True) -> Iterator[dict]:
        """One epoch of numpy minibatches through the streaming
        executor (optionally re-shuffled per call)."""
        ds = self._ds
        if self._shuffle:
            seed = self._seed
            if seed is not None:
                self._seed = seed + 1          # new permutation per epoch
            ds = ds.random_shuffle(seed=seed)
        for batch in ds.iter_batches(batch_size=batch_size,
                                     batch_format="numpy",
                                     drop_last=drop_last):
            yield {k: _column_to_array(batch[k])
                   for k in columns if k in batch}
