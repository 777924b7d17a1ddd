"""DataIterator + streaming split: coordinated per-consumer streams
(counterpart of ant_ray_tpu/data/iterator.py).

Mirror of the reference's ``Dataset.streaming_split``
(ref: python/ray/data/dataset.py:1881) and ``DataIterator``
(ref: python/ray/data/iterator.py:55), redesigned for this runtime:

* ``Dataset.streaming_split(n)`` spawns ONE ``_SplitCoordinator`` actor
  holding the logical plan.  Each epoch, the coordinator drives the
  streaming executor once in a background thread and fans block *refs*
  out to ``n`` bounded per-consumer queues — blocks themselves move
  store-to-store and spill under pressure; the coordinator only ever
  holds a handful of refs (queue cap + one held-back tail block per
  consumer), so the footprint is bounded no matter the dataset size.
* Epochs are coordinated: every consumer's ``iter_batches`` call hits a
  barrier (``start_epoch``) so a new pass over the data starts only
  when all ranks finished the previous one — the semantics SPMD
  training needs (ref: StreamSplitDataIterator's coordinator,
  python/ray/data/_internal/execution/operators/output_splitter.py).
* ``equal=True`` guarantees every consumer yields EXACTLY the same row
  count per epoch (collective lockstep must not deadlock on a short
  rank): blocks dispatch greedily to the consumer with the fewest rows
  (in-stream imbalance ≤ one block), the tail block per consumer is
  held back, and at stream end tails are sliced so all match the
  minimum; a stream with fewer blocks than consumers splits tail
  blocks further so nobody starves.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Iterator

from ant_ray_tpu_torch.data.block import batches_from_blocks

logger = logging.getLogger(__name__)

# Block refs buffered per output split: the producer thread stalls when
# a consumer's queue is full, which stalls the executor's pull, which
# stops launching read/map tasks — end-to-end backpressure.
_QUEUE_CAP = 2
# How long a rank parked at a retry barrier waits after a PREVIOUS
# epoch failed with no sign of the other ranks retrying, before the
# failure is surfaced to it too (epoch-scoped errors keep the stale
# failure out of a genuine retry; this grace keeps a gang that is NOT
# retrying from parking the early rank forever).
_BARRIER_GRACE_S = 30.0


def _art():
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    return art


class DataIterator:
    """One consumer's stream over a dataset (ref:
    python/ray/data/iterator.py:55).  Each ``iter_batches`` /
    ``iter_rows`` call is one full pass (one epoch); concrete
    subclasses supply the block-ref stream."""

    # Defaults for iter_device_batches, set via configure_device_feed
    # (the trainer forwards DataConfig.device_feed per rank through it).
    _device_feed_defaults: dict | None = None
    _last_device_feed = None

    def _iter_block_refs(self) -> Iterator:
        raise NotImplementedError

    def _iter_blocks(self) -> Iterator:
        art = _art()
        for ref in self._iter_block_refs():
            yield art.get(ref)

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "default",
                     drop_last: bool = False) -> Iterator:
        yield from batches_from_blocks(self._iter_blocks(), batch_size,
                                       batch_format, drop_last)

    def iter_rows(self) -> Iterator:
        from ant_ray_tpu_torch.data.block import BlockAccessor  # noqa: PLC0415

        for block in self._iter_blocks():
            yield from BlockAccessor.for_block(block).to_rows()

    def iter_device_batches(self, batch_size: int | None = None,
                            prefetch_batches: int | None = None,
                            sharding=None, collate_fn=None, *,
                            drop_last: bool | None = None,
                            pad_value=None) -> Iterator:
        """One epoch of prefetched, double-buffered DEVICE batches.

        A background producer thread pulls blocks, collates rows into
        contiguous fixed-shape arrays (the tail batch pads to
        ``batch_size`` so a step sees one shape), and on CUDA copies
        them from pinned host memory on a side stream of its own into a
        bounded queue — the host→card copy for batch N+1 overlaps the
        step for batch N (data/device_feed.py).  ``prefetch_batches=0``
        is the blocking baseline (the copy on the critical path).
        ``sharding`` is the device: a ``torch.device`` or string, a
        callable ``(rank, world) -> device`` resolved lazily in the
        consuming process, or None for the current CUDA device.
        Per-stage timings land in ``stats()["device_feed"]``.
        """
        from ant_ray_tpu_torch.data.device_feed import DeviceFeed  # noqa: PLC0415

        d = self._device_feed_defaults or {}
        feed = DeviceFeed(
            self._iter_blocks,
            batch_size=(batch_size if batch_size is not None
                        else d.get("batch_size", 256)),
            prefetch_batches=(prefetch_batches
                              if prefetch_batches is not None
                              else d.get("prefetch_batches", 2)),
            sharding=sharding if sharding is not None else d.get("sharding"),
            collate_fn=(collate_fn if collate_fn is not None
                        else d.get("collate_fn")),
            drop_last=(drop_last if drop_last is not None
                       else d.get("drop_last", False)),
            pad_value=(pad_value if pad_value is not None
                       else d.get("pad_value", 0)),
            rank=d.get("rank", getattr(self, "_rank", 0)),
            world=d.get("world", getattr(self, "_world", 1)),
        )
        self._last_device_feed = feed
        return iter(feed)

    def configure_device_feed(self, **defaults) -> "DataIterator":
        """Set defaults for :meth:`iter_device_batches` (keys:
        batch_size, prefetch_batches, sharding, collate_fn, drop_last,
        pad_value, rank, world).  The train controller calls this per
        rank from ``DataConfig.device_feed``; explicit call-site
        arguments still win."""
        merged = dict(self._device_feed_defaults or {})
        merged.update(defaults)
        self._device_feed_defaults = merged
        return self

    def stats(self) -> dict:
        """Observability surface: per-stage timings of the most recent
        (possibly still-running) device feed under ``"device_feed"``
        (block-wait, collate, transfer-issue, consumer-starve)."""
        out: dict = {}
        feed = self._last_device_feed
        if feed is not None:
            out["device_feed"] = dict(feed.stats)
        return out

    def __getstate__(self):
        # Iterators ship to workers; a live feed (thread handle) does
        # not survive pickling and never needs to.
        state = dict(self.__dict__)
        state.pop("_last_device_feed", None)
        return state

    def materialize(self):
        """Drain one epoch into a plain Dataset (refs, not rows)."""
        from ant_ray_tpu_torch.data.dataset import Dataset  # noqa: PLC0415

        return Dataset(list(self._iter_block_refs()))


class PlanIterator(DataIterator):
    """Full-dataset iterator: every pass re-executes the plan (the
    non-split path — e.g. a validation set broadcast to all workers)."""

    def __init__(self, dataset):
        self._ds = dataset

    def _iter_block_refs(self) -> Iterator:
        return self._ds._iter_result_refs()

    def __repr__(self):
        return f"PlanIterator({self._ds!r})"


class StreamSplitDataIterator(DataIterator):
    """Consumer ``rank`` of an n-way coordinated streaming split.

    Serializable (actor handle + ints) — the trainer ships one per
    worker; ``train.get_dataset_shard`` hands it to the loop."""

    def __init__(self, coordinator, rank: int, world: int, name: str = ""):
        self._coord = coordinator
        self._rank = rank
        self._world = world
        self._name = name
        self._epoch = 0

    def _iter_block_refs(self) -> Iterator:
        art = _art()
        epoch = self._epoch
        self._epoch += 1
        # Barrier: a new pass starts only when every rank asked for it.
        art.get(self._coord.start_epoch.remote(self._rank, epoch))
        # One-deep pipeline: the request for block k+1 is in flight
        # while the consumer processes block k, hiding the coordinator
        # round-trip (mirror of the reference iterator's prefetch).
        pending = self._coord.next_block.remote(self._rank, epoch)
        while True:
            kind, payload = art.get(pending)
            if kind == "block":
                pending = self._coord.next_block.remote(self._rank, epoch)
                yield payload
            elif kind == "end":
                return
            else:
                raise RuntimeError(
                    f"streaming split '{self._name}' failed: {payload}")

    def stats(self) -> dict:
        out = _art().get(self._coord.stats.remote())
        out.update(DataIterator.stats(self))   # adds "device_feed"
        return out

    def __repr__(self):
        return (f"StreamSplitDataIterator(name={self._name!r}, "
                f"rank={self._rank}/{self._world})")


class _Aborted(Exception):
    """Producer thread raced a coordinator teardown/new generation."""


class _SplitCoordinator:
    """Actor coordinating one Dataset stream over ``n`` consumers.

    Runs with max_concurrency > n: every rank parks a blocking
    ``next_block`` call here while the producer thread feeds queues.
    """

    def __init__(self, dataset, n: int, equal: bool, name: str = ""):
        self._ds = dataset
        self._n = n
        self._equal = equal
        self._name = name
        self._cv = threading.Condition()
        self._queues: list[deque] = [deque() for _ in range(n)]
        self._epoch = -1               # epoch currently running/finished
        self._arrived: set = set()     # (epoch, rank) barrier arrivals
        self._done = False             # current epoch's stream exhausted
        # Errors are scoped (epoch, repr): a retried epoch must never
        # see the previous epoch's failure (a rank arriving early at
        # the new barrier would otherwise re-raise the stale error and
        # desync the gang forever).
        self._error: "tuple[int, str] | None" = None
        self._rows_out = [0] * n       # last finished epoch's row counts
        self._epochs_finished = 0

    # ---- consumer API

    def start_epoch(self, rank: int, epoch: int) -> bool:
        with self._cv:
            if epoch <= self._epoch:
                return True            # already running (late re-entry)
            self._arrived.add((epoch, rank))
            # Wake the producer: a rank parked at a FUTURE barrier has
            # abandoned the current epoch (broke out of its batch loop)
            # and must not be pushed to (its full queue would deadlock
            # the stream for everyone else).
            self._cv.notify_all()
            if all((epoch, r) in self._arrived for r in range(self._n)):
                self._arrived = {p for p in self._arrived
                                 if p[0] > epoch}
                self._epoch = epoch
                self._done = False
                self._error = None
                for q in self._queues:
                    q.clear()
                threading.Thread(target=self._run_epoch, args=(epoch,),
                                 daemon=True).start()
                self._cv.notify_all()
            else:
                grace_deadline = None
                seen_arrivals = len(self._arrived)
                while not (self._epoch >= epoch
                           or self._epoch_error(epoch) is not None):
                    self._cv.wait(timeout=1.0)
                    if len(self._arrived) != seen_arrivals:
                        seen_arrivals = len(self._arrived)
                        grace_deadline = None   # gang is arriving
                    prev = self._error
                    if (prev is not None and prev[0] < epoch
                            and self._epoch < epoch):
                        # A previous epoch failed and this barrier is
                        # not filling: the other ranks may never retry.
                        now = time.monotonic()
                        if grace_deadline is None:
                            grace_deadline = now + _BARRIER_GRACE_S
                        elif now >= grace_deadline:
                            raise RuntimeError(
                                f"streaming split '{self._name}' "
                                f"barrier for epoch {epoch} abandoned: "
                                f"epoch {prev[0]} failed ({prev[1]}) "
                                "and the other consumers did not retry")
            return True

    def _epoch_error(self, epoch: int) -> str | None:
        """The recorded error IF it belongs to ``epoch`` (errors are
        (epoch, repr) pairs; other epochs' failures are invisible)."""
        if self._error is not None and self._error[0] == epoch:
            return self._error[1]
        return None

    def next_block(self, rank: int, epoch: int):
        with self._cv:
            while True:
                err = self._epoch_error(epoch)
                if err is not None:
                    return ("error", err)
                if epoch < self._epoch:
                    # A newer epoch started (this consumer was resliced
                    # away mid-stream) — its old stream is over.
                    return ("end", None)
                if self._queues[rank]:
                    ref = self._queues[rank].popleft()
                    self._cv.notify_all()     # queue room → wake producer
                    # Handing the ref to the consumer drops this actor's
                    # last strong reference (the queue slot); a grace
                    # pin bridges to the consumer's borrow registration,
                    # like device_objects does for the same hand-off.
                    self._grace_pin(ref)
                    return ("block", ref)
                if self._done:
                    return ("end", None)
                self._cv.wait(timeout=1.0)

    @staticmethod
    def _grace_pin(ref) -> None:
        try:
            from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

            global_worker.runtime.pin_for_grace(ref)
        except Exception:  # noqa: BLE001 — pin is belt-and-braces only
            pass

    def stats(self) -> dict:
        with self._cv:
            return {"name": self._name, "splits": self._n,
                    "equal": self._equal,
                    "epochs_finished": self._epochs_finished,
                    "rows_per_split": list(self._rows_out)}

    # ---- producer (one thread per epoch)

    def _run_epoch(self, epoch: int) -> None:
        try:
            if self._equal:
                self._produce_equal(epoch)
            else:
                self._produce_any(epoch)
            with self._cv:
                if self._epoch == epoch:
                    self._done = True
                    self._epochs_finished += 1
                    self._cv.notify_all()
        except _Aborted:
            pass
        except Exception as e:  # noqa: BLE001 — surfaced to consumers
            logger.exception("streaming split '%s' epoch %d failed",
                             self._name, epoch)
            with self._cv:
                # Only poison the epoch that actually failed; a late
                # failure from a superseded epoch's thread must not
                # leak into the one now running.
                if self._epoch == epoch:
                    self._error = (epoch, repr(e))
                    self._cv.notify_all()

    def _abandoned(self, rank: int, epoch: int) -> bool:
        return any(r == rank and e > epoch for e, r in self._arrived)

    def _push(self, rank: int, ref, epoch: int) -> None:
        with self._cv:
            self._cv.wait_for(
                lambda: len(self._queues[rank]) < _QUEUE_CAP
                or self._abandoned(rank, epoch)
                or self._epoch != epoch
                or self._epoch_error(epoch) is not None)
            if self._epoch != epoch or self._epoch_error(epoch) is not None:
                raise _Aborted
            if self._abandoned(rank, epoch):
                return                 # consumer left this epoch; drop
            self._queues[rank].append(ref)
            self._cv.notify_all()

    def _shortest_queue(self, epoch: int) -> int:
        """Rank with the most queue room (ties → lowest rank); waits
        until someone has room."""
        with self._cv:
            self._cv.wait_for(
                lambda: any(len(q) < _QUEUE_CAP for q in self._queues)
                or self._epoch != epoch
                or self._epoch_error(epoch) is not None)
            if self._epoch != epoch or self._epoch_error(epoch) is not None:
                raise _Aborted
            return min(range(self._n),
                       key=lambda r: (len(self._queues[r]), r))

    def _produce_any(self, epoch: int) -> None:
        """equal=False: dynamic dispatch to whichever consumer has queue
        room — natural load balancing, no row counting."""
        for ref in self._ds._iter_result_refs():
            self._push(self._shortest_queue(epoch), ref, epoch)

    def _produce_equal(self, epoch: int) -> None:
        """equal=True: greedy min-rows dispatch with one held-back tail
        block per consumer, trimmed at stream end so every consumer
        gets exactly min-rows rows."""
        art = _art()
        from ant_ray_tpu_torch.data.executor import (  # noqa: PLC0415
            _block_rows,
            _slice_remote,
        )

        rows_remote = art.remote(_block_rows)
        slice_remote = art.remote(_slice_remote)
        rows = [0] * self._n           # dispatched rows incl. held tail
        held: list = [None] * self._n  # held-back tail ref per rank
        held_rows = [0] * self._n

        def dispatch(ref, cnt: int) -> None:
            if cnt == 0:
                return
            target = min(range(self._n), key=lambda r: (rows[r], r))
            rows[target] += cnt
            prev, held[target] = held[target], ref
            held_rows[target] = cnt
            if prev is not None:
                self._push(target, prev, epoch)

        # Row counts pipeline a few blocks ahead of dispatch — one
        # serial submit+get round-trip per block would cap the stream
        # at the scheduler RTT.
        counting: deque = deque()      # (ref, count_ref)
        for ref in self._ds._iter_result_refs():
            counting.append((ref, rows_remote.remote(ref)))
            if len(counting) >= 4:
                head, cnt_ref = counting.popleft()
                dispatch(head, art.get(cnt_ref))
        while counting:
            head, cnt_ref = counting.popleft()
            dispatch(head, art.get(cnt_ref))
        # Starved consumers (stream had fewer blocks than splits): split
        # the largest tail in two until everyone holds something.
        while min(rows) == 0 and max(held_rows) > 1:
            donor = max(range(self._n), key=lambda r: held_rows[r])
            taker = rows.index(0)
            half = held_rows[donor] // 2
            hi = slice_remote.remote(held[donor], half, held_rows[donor])
            lo = slice_remote.remote(held[donor], 0, half)
            held[taker], held_rows[taker] = hi, held_rows[donor] - half
            rows[taker] = held_rows[taker]
            rows[donor] -= held_rows[taker]
            held[donor], held_rows[donor] = lo, half
        # Trim every tail to the global minimum.  Greedy dispatch keeps
        # each rank's excess ≤ its tail block's rows, so slicing the
        # tail alone suffices.
        target_rows = min(rows)
        for r in range(self._n):
            excess = rows[r] - target_rows
            if held[r] is None:
                continue
            if excess >= held_rows[r]:
                rows[r] -= held_rows[r]
                continue               # drop the whole tail
            if excess > 0:
                held[r] = slice_remote.remote(
                    held[r], 0, held_rows[r] - excess)
                rows[r] -= excess
            self._push(r, held[r], epoch)
        with self._cv:
            self._rows_out = rows


def make_streaming_split(dataset, n: int, equal: bool = False,
                         name: str = "") -> list[StreamSplitDataIterator]:
    """Build the coordinator actor + n consumer iterators (the body of
    Dataset.streaming_split; also called directly by the trainer)."""
    art = _art()
    coord = art.remote(_SplitCoordinator).options(
        # Every rank parks a call here while the producer runs; leave
        # headroom for stats/barrier calls on top.
        max_concurrency=2 * n + 4, num_cpus=0,
    ).remote(dataset, n, equal, name)
    return [StreamSplitDataIterator(coord, r, n, name) for r in range(n)]
