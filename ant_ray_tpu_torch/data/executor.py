"""Streaming executor: pull-based block streaming with backpressure.

The reference's StreamingExecutor drives an operator topology with
resource-aware backpressure policies (ref:
data/_internal/execution/streaming_executor.py:67 +
backpressure_policy/).  Here each stage is a generator of block refs
pulling from the previous stage, with two-level backpressure per stage:
at most ``data_inflight_tasks`` outstanding tasks AND (when block sizes
are known) at most ``data_inflight_bytes`` of estimated in-flight input
bytes.  All-to-all stages (shuffle / sort / groupby / repartition) run
as map-reduce task graphs over ``num_returns=k`` splits with

  * a **windowed split phase** — split tasks launch over the upstream
    with bounded in-flight work, and the driver drops each source
    block's ref as soon as its split completes, so consumed inputs are
    refcount-freed/evicted while later blocks are still arriving;
  * a **lazy merge phase** — per-partition merges launch on downstream
    demand (small lookahead for pipelining), and each merged column's
    piece refs are nulled out at launch, so finished partitions drain
    from the store while later partitions still hold their pieces.

Nothing ever materializes the dataset in the driver: the driver holds
refs only; blocks move store-to-store and spill under pressure.
"""

from __future__ import annotations

import hashlib
import pickle
import random
from collections import deque
from typing import Callable, Iterator

from ant_ray_tpu_torch.data import block as B
from ant_ray_tpu_torch.data import logical as L

DEFAULT_IN_FLIGHT = 8


def _stable_hash(value) -> int:
    """Deterministic across processes — builtin hash() is per-process
    randomized for strings, which would split one group over several
    hash partitions (double-counted aggregates)."""
    digest = hashlib.md5(pickle.dumps(value, protocol=4)).digest()
    return int.from_bytes(digest[:8], "big")


def _art():
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    return art


def _cfg():
    from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

    return global_config()


# ----------------------------------------------------------- remote fns

def _apply_fused(fused: L.FusedMap, block):
    return fused(block)


def _split_block(block, k: int, mode: str, seed):
    """Map side of a shuffle: one block → k partition pieces.

    For k == 1 the single piece is returned bare (the task runs with
    num_returns=1, where a list would be treated as one list-block)."""
    accessor = B.BlockAccessor.for_block(block)
    n = accessor.num_rows()
    if k == 1:
        return block
    if mode == "even":
        bounds = [round(i * n / k) for i in range(k + 1)]
        return [accessor.slice(bounds[i], bounds[i + 1])
                for i in range(k)]
    rows = accessor.to_rows()
    parts: list[list] = [[] for _ in range(k)]
    if mode == "random":
        # seed = (user seed, block index): distinct stream per block —
        # one shared stream would send row i of every block to the same
        # partition sequence.
        rng = random.Random(seed)
        for row in rows:
            parts[rng.randrange(k)].append(row)
    elif mode == "hash":
        key = seed  # the group key rides the seed slot
        for row in rows:
            value = key(row) if callable(key) else row[key]
            parts[_stable_hash(value) % k].append(row)
    else:  # pragma: no cover — range mode uses _split_block_range
        raise ValueError(mode)
    return [B.rows_to_block(p, block) for p in parts]


def _split_block_range(block, boundaries: list, key, descending: bool):
    """Range partition for sort: rows → len(boundaries)+1 pieces (bare
    block when there is a single piece — see _split_block)."""
    import bisect  # noqa: PLC0415

    if not boundaries:
        return block
    accessor = B.BlockAccessor.for_block(block)
    rows = accessor.to_rows()
    values = accessor.sort_key_values(key)
    k = len(boundaries) + 1
    parts: list[list] = [[] for _ in range(k)]
    for row, value in zip(rows, values):
        idx = bisect.bisect_left(boundaries, value)
        if descending:
            idx = k - 1 - idx
        parts[idx].append(row)
    return [B.rows_to_block(p, block) for p in parts]


def _merge_blocks(*pieces):
    return B.concat_blocks(list(pieces))


def _merge_shuffled(seed, *pieces):
    """Reduce side of random_shuffle: concat then Fisher-Yates within
    the partition — split alone keeps source order inside each
    partition (position-correlated training batches)."""
    merged = B.concat_blocks(list(pieces))
    rows = B.BlockAccessor.for_block(merged).to_rows()
    random.Random(seed).shuffle(rows)
    return B.rows_to_block(rows, merged)


def _merge_sorted(key, descending: bool, *pieces):
    merged = B.concat_blocks(list(pieces))
    accessor = B.BlockAccessor.for_block(merged)
    rows = accessor.to_rows()
    values = accessor.sort_key_values(key)
    order = sorted(range(len(rows)), key=values.__getitem__,
                   reverse=descending)
    return B.rows_to_block([rows[i] for i in order], merged)


def _merge_grouped(key, aggs, *pieces):
    """Reduce side of groupby: hash-partitioned rows → one row per
    group with finalized aggregates."""
    merged = B.concat_blocks(list(pieces))
    accessor = B.BlockAccessor.for_block(merged)
    groups: dict = {}
    for row in accessor.to_rows():
        group = key(row) if callable(key) else row[key]
        accs = groups.get(group)
        if accs is None:
            accs = [agg.init() for agg in aggs]
            groups[group] = accs
        for i, agg in enumerate(aggs):
            accs[i] = agg.accumulate(accs[i], agg.value_of(row))
    out = []
    key_name = key if isinstance(key, str) else "key"
    for group, accs in groups.items():
        row = {key_name: group}
        for agg, acc in zip(aggs, accs):
            row[agg.name] = agg.finalize(acc)
        out.append(row)
    return out


def _sample_keys(block, key, k: int, seed: int):
    accessor = B.BlockAccessor.for_block(block)
    values = accessor.sort_key_values(key)
    rng = random.Random(seed)
    if len(values) <= k:
        return list(values)
    return rng.sample(list(values), k)


def _block_rows(block) -> int:
    return B.BlockAccessor.for_block(block).num_rows()


def _slice_remote(block, start: int, end: int):
    return B.BlockAccessor.for_block(block).slice(start, end)


# ------------------------------------------------- streaming machinery

def _sizes(refs: list) -> list:
    """Best-effort per-ref payload sizes (None when pending/unknown) —
    feeds the byte budget.  Driver-owned refs answer from the local
    memory store, so this is in-process, not an RPC fan-out."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    try:
        return global_worker.runtime.object_sizes(list(refs))
    except Exception:  # noqa: BLE001 — sizes are an optimization only
        return [None] * len(refs)


def _window_bytes(in_refs: list, known: dict) -> int:
    """Estimated bytes held by the window's input blocks.  ``known``
    memoizes resolved sizes (block payloads are immutable once ready),
    so only still-pending refs are re-queried; unknown sizes assume the
    average of the known ones (0 until anything is known)."""
    unknown = [r for r in in_refs if r.id not in known]
    if unknown:
        for ref, size in zip(unknown, _sizes(unknown)):
            if size is not None:
                known[ref.id] = size
    sizes = [known.get(r.id) for r in in_refs]
    resolved = [s for s in sizes if s]
    if not resolved:
        return 0
    avg = sum(resolved) // len(resolved)
    return sum(s if s else avg for s in sizes)


def _probe(out) -> object:
    """The ref whose completion signals a launched task finished (first
    return for num_returns=k tasks)."""
    return out[0] if isinstance(out, list) else out


def _windowed(upstream: Iterator, launch: Callable,
              tasks_cap: int | None = None,
              ref_of: Callable = lambda item: item) -> Iterator:
    """Ordered bounded-launch pipeline: apply ``launch`` to each
    upstream item with at most ``tasks_cap`` outstanding tasks and at
    most ``data_inflight_bytes`` estimated in-flight input bytes; the
    head task is awaited before its output is yielded, so demand
    propagates backwards.  Input items are dropped as their tasks are
    yielded — a consumed source block loses its driver ref and becomes
    freeable while later blocks still stream in.  ``ref_of`` extracts
    the input block ref from an item (for enumerated streams)."""
    art = _art()
    cfg = _cfg()
    tasks_cap = tasks_cap or cfg.data_inflight_tasks
    bytes_cap = cfg.data_inflight_bytes
    window: deque = deque()          # (out, in_ref)
    known_sizes: dict = {}           # ref.id -> bytes, sticky once known
    upstream = iter(upstream)
    exhausted = False
    while True:
        while not exhausted and len(window) < tasks_cap:
            if bytes_cap and window and \
                    _window_bytes([i for _, i in window],
                                  known_sizes) >= bytes_cap:
                break
            try:
                item = next(upstream)
            except StopIteration:
                exhausted = True
                break
            window.append((launch(item), ref_of(item)))
        if not window:
            return
        out, src = window.popleft()
        known_sizes.pop(getattr(src, "id", None), None)
        art.wait([_probe(out)], num_returns=1, timeout=600)
        yield out


def _merge_stream(rows: list, make_merge: Callable, k: int,
                  lookahead: int = 2) -> Iterator:
    """Lazy reduce phase: partition j's merge launches only when
    downstream demand reaches it (plus ``lookahead`` pipelined ahead);
    launched columns are nulled out of ``rows`` so merged partitions'
    pieces free while later columns still hold theirs."""
    launched: deque = deque()
    next_j = 0

    def _launch():
        nonlocal next_j
        column = [row[next_j] for row in rows]
        launched.append(make_merge(next_j, column))
        for row in rows:
            row[next_j] = None
        next_j += 1

    while next_j < k and len(launched) < lookahead:
        _launch()
    while launched:
        out = launched.popleft()
        if next_j < k:
            _launch()
        yield out


def _as_row(out) -> list:
    # num_returns=1 split tasks return a bare ref; widen to a 1-row.
    return out if isinstance(out, list) else [out]


def _collect_rows(upstream: Iterator, make_split: Callable,
                  ref_of: Callable = lambda item: item) -> list:
    """Windowed split phase: returns the piece-ref matrix (refs only —
    the pieces themselves live in the store and spill under pressure).
    Source refs are dropped as their splits complete."""
    return [_as_row(out)
            for out in _windowed(upstream, make_split, ref_of=ref_of)]


# ------------------------------------------------------------- stages

def _map_stage(upstream: Iterator, fused: L.FusedMap,
               in_flight: int) -> Iterator:
    """Ordered, bounded map over a ref stream (backpressure: at most
    ``in_flight`` tasks / ``data_inflight_bytes`` bytes outstanding;
    upstream pulled only when a slot frees)."""
    art = _art()
    apply_remote = art.remote(_apply_fused)
    yield from _windowed(upstream, lambda r: apply_remote.remote(fused, r),
                         tasks_cap=in_flight)


_store_capacity_cache: dict = {}


def _store_capacity() -> int | None:
    """Local node's shared-memory store capacity (cached per node
    address — clusters restart within one test process) — bounds the
    target partition size so a merge output can always fit."""
    try:
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        runtime = global_worker.runtime
        addr = runtime.node_address
        if addr in _store_capacity_cache:
            return _store_capacity_cache[addr]
        # Reuse the runtime's live client pool — a fresh ClientPool
        # would leak one never-closed connection per node address.
        node = runtime._clients.get(addr)
        cap = node.call("GetStoreStats", {}, timeout=5)["capacity"]
        _store_capacity_cache[addr] = cap
        return cap
    except Exception:  # noqa: BLE001 — stats are an optimization only
        return None


def _pick_k(refs: list, requested: int | None) -> int:
    """Partition count: the caller's explicit block count, else
    total-bytes / target (size-aware repartitioning: target is
    data_target_block_bytes clamped to ⅛ of store capacity so merge
    outputs always fit the store), else the input block count."""
    if requested:
        return requested
    n = max(1, len(refs))
    sizes = [s for s in _sizes(refs) if s]
    if sizes:
        total = sum(sizes) * len(refs) // len(sizes)  # scale up unknowns
        target = max(1, _cfg().data_target_block_bytes)
        cap = _store_capacity()
        if cap:
            target = min(target, max(1, cap // 8))
        k = max(1, -(-total // target))
        return max(min(k, 4 * n), 1)
    return n


def _shuffle_stage(upstream: Iterator, requested_k: int | None,
                   mode: str, seed) -> Iterator:
    """Generic map-reduce shuffle: windowed split phase then lazy merge
    phase (pieces move store-to-store, never through the driver).
    mode="random" uses per-block split streams and a within-partition
    permutation at the merge — together a real two-stage uniform
    shuffle."""
    art = _art()
    if requested_k:
        k = requested_k
        refs: Iterator = upstream
    else:
        # Auto block count needs the input cardinality/size — collect
        # the *refs* (not blocks) first.
        collected = list(upstream)
        k = _pick_k(collected, None)
        refs = iter(collected)
    split_remote = art.remote(_split_block).options(num_returns=k)
    if mode == "random":
        if seed is None:  # derived streams must differ run to run
            seed = random.randrange(2**63)
        merge_shuffled = art.remote(_merge_shuffled)
        rows = _collect_rows(
            enumerate(refs),
            lambda item: split_remote.remote(
                item[1], k, mode, _stable_hash(("split", seed, item[0]))),
            ref_of=lambda item: item[1])
        yield from _merge_stream(
            rows, lambda j, col: merge_shuffled.remote(
                _stable_hash(("merge", seed, j)), *col), k)
        return
    rows = _collect_rows(refs,
                         lambda r: split_remote.remote(r, k, mode, seed))
    merge_remote = art.remote(_merge_blocks)
    yield from _merge_stream(rows,
                             lambda j, col: merge_remote.remote(*col), k)


def _sorted_stage(upstream: Iterator, key, descending: bool) -> Iterator:
    """Sample → range-partition → streaming merge (ref: the sort path
    of the streaming executor).  The sample pass streams over the
    upstream with bounded in-flight sample tasks; source refs must
    survive to the split pass (sort re-reads them), so sort's driver
    working set is the ref list plus one merge column of pieces —
    the blocks themselves spill under pressure."""
    art = _art()
    sample_remote = art.remote(_sample_keys)
    refs: list = []
    sample_refs: list = []
    cap = _cfg().data_inflight_tasks
    for ref in upstream:
        refs.append(ref)
        sample_refs.append(sample_remote.remote(ref, key, 8, len(refs)))
        if len(sample_refs) >= cap:
            # Bound concurrent sample tasks: wait out the one `cap`
            # launches back before admitting the next.
            art.wait([sample_refs[-cap]], num_returns=1, timeout=600)
    samples: list = []
    for chunk in art.get(sample_refs):
        samples.extend(chunk)
    samples.sort()
    k = _pick_k(refs, None)
    if len(samples) > 1 and k > 1:
        step = len(samples) / k
        boundaries = [samples[min(int(step * i), len(samples) - 1)]
                      for i in range(1, k)]
    else:
        boundaries = []
    k = len(boundaries) + 1
    split_remote = art.remote(_split_block_range).options(num_returns=k)
    rows = _collect_rows(
        iter(refs),
        lambda r: split_remote.remote(r, boundaries, key, descending))
    del refs  # sources consumed by the split pass — free/evictable
    merge_remote = art.remote(_merge_sorted)
    yield from _merge_stream(
        rows, lambda j, col: merge_remote.remote(key, descending, *col), k)


def _grouped_stage(upstream: Iterator, key, aggs) -> Iterator:
    art = _art()
    collected = list(upstream)
    k = _pick_k(collected, None)
    split_remote = art.remote(_split_block).options(num_returns=k)
    rows = _collect_rows(iter(collected),
                         lambda r: split_remote.remote(r, k, "hash", key))
    del collected
    merge_remote = art.remote(_merge_grouped)
    yield from _merge_stream(
        rows, lambda j, col: merge_remote.remote(key, tuple(aggs), *col), k)


def _limit_stage(upstream: Iterator, n: int) -> Iterator:
    art = _art()
    rows_remote = art.remote(_block_rows)
    slice_remote = art.remote(_slice_remote)
    remaining = n
    for ref in upstream:
        if remaining <= 0:
            return
        rows = art.get(rows_remote.remote(ref))
        if rows <= remaining:
            remaining -= rows
            yield ref
        else:
            yield slice_remote.remote(ref, 0, remaining)
            remaining = 0


# ------------------------------------------------------------ executor

def execute(source: Callable[[], Iterator], operators: tuple,
            in_flight: int = DEFAULT_IN_FLIGHT) -> Iterator:
    """Stream block refs through the optimized operator chain.  Every
    stage (including the all-to-all ones) is a generator — demand
    propagates backwards from the consumer, and no stage materializes
    the dataset in the driver."""
    stream: Iterator = source()
    for op in L.optimize(operators):
        if isinstance(op, L.FusedMap):
            stream = _map_stage(stream, op, in_flight)
        elif isinstance(op, L.Repartition):
            stream = _shuffle_stage(stream, op.num_blocks, "even", None)
        elif isinstance(op, L.RandomShuffle):
            stream = _shuffle_stage(stream, op.num_blocks, "random",
                                    op.seed)
        elif isinstance(op, L.Sort):
            stream = _sorted_stage(stream, op.key, op.descending)
        elif isinstance(op, L.GroupByAggregate):
            stream = _grouped_stage(stream, op.key, op.aggs)
        elif isinstance(op, L.Limit):
            stream = _limit_stage(stream, op.n)
        else:  # pragma: no cover
            raise ValueError(f"unknown operator {op}")
    return stream
