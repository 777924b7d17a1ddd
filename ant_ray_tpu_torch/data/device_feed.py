"""Device-feed: prefetched, double-buffered host→device batch delivery
(counterpart of ant_ray_tpu/data/device_feed.py, rewritten for CUDA).

The ingest gap this closes (T3, arxiv 2401.16677 — fine-grained overlap
of data movement with compute): ``iter_batches`` stops at host numpy
batches, so every step pays collate + host→card copy on the critical
path.  ``iter_device_batches`` moves both off it:

* a background **producer thread** pulls blocks, collates rows into
  contiguous fixed-shape arrays (the tail batch pads to ``batch_size``
  so a step sees one shape), copies them into **page-locked host
  buffers**, and issues ``.to(device, non_blocking=True)`` on a **side
  stream** of its own, recording an event after the copies — the
  host→card DMA for batch N+1 overlaps the step for batch N;
* a **bounded queue** (``prefetch_batches`` deep — 2 is classic double
  buffering) backpressures the producer so at most that many batches
  are in flight on the card;
* the consumer's stream **waits on the batch's event** before the batch
  is yielded (the host never waits), and each tensor is
  ``record_stream``-ed on the consumer's stream, so the caching
  allocator cannot hand its memory to a later copy while the step
  still reads it;
* the page-locked buffers come from torch's caching host allocator,
  which records each copy's event and hands a buffer out again only
  after that event has completed.

A ``non_blocking`` copy from pageable memory is synchronous, which
would silently remove the overlap, so on CUDA the pinned side-stream
path is the only one: if it cannot run, the feed raises.  On the CPU
(``sharding="cpu"``) the feed yields CPU tensors and pins nothing.

``prefetch_batches=0`` is the synchronous baseline (collate + copy +
its completion inline in the consumer's loop); it exists so the overlap
is observable — the consumer's starve fraction for both modes.

Every stage is timed into ``DeviceFeed.stats`` (block-wait, collate,
transfer-issue, consumer-starve), surfaced through
``DataIterator.stats()["device_feed"]``.

torch is imported when a feed starts, never when this module loads.
"""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
import time
from typing import Any, Callable

import numpy as np

_END = ("end", None)


def default_collate(batch) -> dict:
    """Numpy batch (dict of columns) → dict of contiguous numpy arrays.

    A list-block column of dict rows explodes into one array per key
    (the ``from_items([{...}])`` path).  Columns that stay object-dtype
    cannot form a fixed-shape device array — pass a ``collate_fn``."""
    if not isinstance(batch, dict):
        batch = {"value": batch}
    out: dict = {}
    for key, col in batch.items():
        arr = np.asarray(col)
        if arr.dtype == object:
            rows = list(col)
            if rows and all(isinstance(r, dict) for r in rows):
                for k in rows[0]:
                    sub = np.asarray([r[k] for r in rows])
                    if sub.dtype == object:
                        raise TypeError(
                            f"row key {k!r} is ragged/non-numeric; pass "
                            "a collate_fn that produces fixed-shape "
                            "arrays")
                    out[k] = np.ascontiguousarray(sub)
                continue
            raise TypeError(
                f"column {key!r} is not dense (dtype=object); pass a "
                "collate_fn that maps the numpy batch to fixed-shape "
                "arrays")
        out[key] = np.ascontiguousarray(arr)
    return out


def pad_to_batch(tree: dict, batch_size: int, pad_value=0):
    """Pad every array's leading dim to ``batch_size`` (returns
    ``(padded_tree, n_padding_rows)``).  Fixed shapes keep a step at one
    shape across the epoch."""
    n = None
    for leaf in tree.values():
        n = leaf.shape[0] if n is None else min(n, leaf.shape[0])
    if n is None or n >= batch_size:
        return tree, 0
    pad = batch_size - n
    out = {
        k: np.concatenate(
            [a, np.full((pad,) + a.shape[1:], pad_value, dtype=a.dtype)])
        for k, a in tree.items()
    }
    return out, pad


def resolve_placement(sharding, rank: int = 0, world: int = 1):
    """``sharding`` → a ``torch.device`` or a ``NamedSharding``: a device
    or its name, a ``parallel.NamedSharding`` (batches then come as
    ShardedTensors laid out by it over its mesh's cells), a callable
    ``(rank, world) ->`` either (or one of no arguments), or None for
    the current CUDA device (raising without one)."""
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch._device import resolve_device  # noqa: PLC0415
    from ant_ray_tpu_torch.parallel.spmd import NamedSharding  # noqa: PLC0415

    if callable(sharding) and not isinstance(sharding, (str, torch.device)):
        try:
            sharding = sharding(rank, world)
        except TypeError:
            sharding = sharding()
    if isinstance(sharding, NamedSharding):
        return sharding
    if isinstance(sharding, (list, tuple, set)):
        raise ValueError(
            "a placement over several devices is a NamedSharding of a "
            "mesh (ant_ray_tpu_torch.parallel); got a collection")
    device = resolve_device(sharding)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceFeed:
    """One epoch of device-batch delivery over a block stream.

    ``blocks_fn`` yields blocks (one pass); iterate the feed once.
    ``sharding`` is the target device or NamedSharding (see
    :func:`resolve_placement`), resolved lazily in the consuming process — a callable is called as
    ``sharding(rank, world)`` (falling back to no-args) so the trainer
    can forward per-worker placements without shipping device handles.
    """

    def __init__(self, blocks_fn: Callable, *, batch_size: int,
                 prefetch_batches: int = 2, sharding: Any = None,
                 collate_fn: Callable | None = None,
                 drop_last: bool = False, pad_value=0,
                 rank: int = 0, world: int = 1):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive: {batch_size}")
        self._blocks_fn = blocks_fn
        self._batch_size = batch_size
        self._prefetch = max(0, int(prefetch_batches))
        self._sharding = sharding
        self._collate = collate_fn or default_collate
        self._drop_last = drop_last
        self._pad_value = pad_value
        self._rank = rank
        self._world = world
        self._placement = None
        self._streams = {}         # the producer's side streams (CUDA)
        self.thread: threading.Thread | None = None
        self.stats: dict = {
            "batch_size": batch_size,
            "prefetch_batches": self._prefetch,
            "batches": 0,
            "tail_padded_rows": 0,
            "block_wait_s": 0.0,
            "collate_s": 0.0,
            "transfer_issue_s": 0.0,
            "consumer_starve_s": 0.0,
            "consumer_wall_s": 0.0,
            "consumer_starve_fraction": 0.0,
        }

    # ---- producer stages

    def _timed_blocks(self):
        it = iter(self._blocks_fn())
        while True:
            t0 = time.perf_counter()
            try:
                block = next(it)
            except StopIteration:
                return
            self.stats["block_wait_s"] += time.perf_counter() - t0
            yield block

    def _host_batches(self):
        from ant_ray_tpu_torch.data.block import batches_from_blocks  # noqa: PLC0415

        for batch in batches_from_blocks(self._timed_blocks(),
                                         self._batch_size, "numpy",
                                         self._drop_last):
            t0 = time.perf_counter()
            tree = self._collate(batch)
            tree, padded = pad_to_batch(tree, self._batch_size,
                                        self._pad_value)
            self.stats["collate_s"] += time.perf_counter() - t0
            self.stats["tail_padded_rows"] += padded
            yield tree

    def _place(self, t, non_blocking: bool = False):
        from ant_ray_tpu_torch.parallel import spmd  # noqa: PLC0415

        if isinstance(self._placement, spmd.NamedSharding):
            return spmd.shard(t, self._placement, non_blocking=non_blocking)
        return t.to(self._placement, non_blocking=non_blocking)

    def _to_device(self, tree):
        """Host tree → ``(device tree, events)``.  On the CPU: tensors
        over the collated arrays, no events.  On CUDA: each array is
        copied into page-locked memory, then copied to the card (to each
        cell of a mesh) without blocking on a side stream of each card,
        then an event is recorded on each."""
        import torch  # noqa: PLC0415

        t0 = time.perf_counter()
        if not self._streams:
            out = {k: self._place(torch.from_numpy(
                       a if a.flags.writeable else a.copy()))
                   for k, a in tree.items()}
            self.stats["transfer_issue_s"] += time.perf_counter() - t0
            return out, None
        with contextlib.ExitStack() as stack:
            for stream in self._streams.values():
                stack.enter_context(torch.cuda.stream(stream))
            out = {k: self._place(torch.from_numpy(a).pin_memory(),
                                  non_blocking=True)
                   for k, a in tree.items()}
            events = {}
            for dev, stream in self._streams.items():
                events[dev] = torch.cuda.Event()
                events[dev].record(stream)
        self.stats["transfer_issue_s"] += time.perf_counter() - t0
        return out, events

    def _hand_over(self, tree, events):
        """The consumer's side of a copy: its streams wait on the copy's
        events (the host does not), and each tensor is recorded on its
        card's stream for the caching allocator."""
        if events is None:
            return tree
        import torch  # noqa: PLC0415

        from ant_ray_tpu_torch.parallel import spmd  # noqa: PLC0415

        for dev, event in events.items():
            torch.cuda.current_stream(dev).wait_event(event)
        for t in tree.values():
            shards = (spmd.unique_shards(t) if isinstance(
                t, spmd.ShardedTensor) else [t])
            for x in shards:
                x.record_stream(torch.cuda.current_stream(x.device))
        return tree

    def _produce(self, q: _queue.Queue, stop: threading.Event) -> None:
        try:
            for tree in self._host_batches():
                if stop.is_set():
                    return
                if not self._put(q, stop, ("batch",
                                           self._to_device(tree))):
                    return
            self._put(q, stop, _END)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            self._put(q, stop, ("error", e))

    @staticmethod
    def _put(q: _queue.Queue, stop: threading.Event, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    # ---- consumer

    def _start(self):
        import torch  # noqa: PLC0415

        self._placement = resolve_placement(self._sharding, self._rank,
                                            self._world)
        devices = (self._placement.device_set
                   if hasattr(self._placement, "device_set")
                   else {self._placement})
        self._streams = {dev: torch.cuda.Stream(dev) for dev in devices
                         if dev.type == "cuda"}

    def __iter__(self):
        self._start()
        wall0 = time.perf_counter()
        try:
            if self._prefetch == 0:
                yield from self._iter_sync()
            else:
                yield from self._iter_prefetched()
        finally:
            wall = time.perf_counter() - wall0
            self.stats["consumer_wall_s"] = wall
            self.stats["consumer_starve_fraction"] = (
                self.stats["consumer_starve_s"] / wall if wall > 0 else 0.0)

    def _iter_sync(self):
        """prefetch_batches=0: the blocking baseline — collate, copy AND
        its completion all on the consumer's critical path."""
        gen = self._host_batches()
        while True:
            t0 = time.perf_counter()
            try:
                tree = next(gen)
            except StopIteration:
                return
            dev, events = self._to_device(tree)
            for event in (events or {}).values():
                event.synchronize()
            self.stats["consumer_starve_s"] += time.perf_counter() - t0
            self.stats["batches"] += 1
            yield self._hand_over(dev, events)

    def _iter_prefetched(self):
        q: _queue.Queue = _queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        self.thread = threading.Thread(
            target=self._produce, args=(q, stop),
            daemon=True, name="device-feed-producer")
        self.thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, payload = q.get()
                self.stats["consumer_starve_s"] += time.perf_counter() - t0
                if kind == "end":
                    return
                if kind == "error":
                    raise payload
                self.stats["batches"] += 1
                yield self._hand_over(*payload)
        finally:
            # Early consumer exit (or normal end): release the producer
            # from a full queue and join it.
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            self.thread.join(timeout=5.0)
