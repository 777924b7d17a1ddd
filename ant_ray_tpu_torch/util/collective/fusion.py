"""Fused bucketed collectives: pytree-aware allreduce coalescing (a
copy of the JAX package's ``util/collective/fusion.py`` for torch
tensors: leaves are packed, reduced and unpacked on their own device and
in their own dtype, and a CUDA bucket is packed on the card).

The per-tensor verbs (``collective.allreduce``) pay fixed launch
overhead per call — a transfer toward the backend, collective dispatch,
readback — so a gradient pytree with hundreds of sub-MiB params is
dominated by overhead, not bytes (T3, arXiv:2401.16677).  This module
closes that gap with the standard bucketed flat-buffer fix:

* **Bucketing** — leaves are grouped by dtype and packed into flat
  1-D buckets of at most ``bucket_bytes`` (default 4 MiB; a single
  leaf larger than the budget gets its own bucket).  One collective
  runs per *bucket*, not per tensor.
* **Plan caching** — the flatten/unflatten layout (which leaf lands at
  which offset of which bucket) is computed once per pytree signature
  (shapes + dtypes + knobs) and LRU-cached, so steady-state training
  steps skip re-planning entirely.  Torch dtypes are named as numpy
  names them ("torch.float32" → "float32"), so the JAX package and
  this one plan the same buckets for the same leaves.
* **Pipelined overlap** — the :class:`PipelinedRunner` issues bucket
  k+1's pack + transfer on a producer thread while bucket k's
  collective executes on the caller's thread (double buffering, same
  discipline as ``data/device_feed.py``).
* **Reduced-precision transport** — opt-in ``transport_dtype=
  "bfloat16"`` packs float buckets at half width; ``transport_dtype=
  "int8"`` goes further with blockwise-scaled int8 quantization (one
  float32 scale per :data:`QUANT_BLOCK` elements riding a small
  sidecar — ~0.25x the float32 wire bytes).  The reduction itself
  always accumulates in float32 (EQuARX-style, arXiv:2506.17615) and
  results cast back to the leaf dtype.  Quantization runs in torch
  where the bucket lives and gives the JAX package's bytes on the same
  float32 input.
* **Gradient-ready overlap** — :class:`GradientSyncer` assigns leaves
  to buckets in *reverse* input order (reverse-topological: the last
  layers' grads, which backward materializes first, fill bucket 0) and
  launches each bucket's collective on a worker thread the moment its
  last leaf is marked ready — so wire time hides under the remaining
  backward compute (DDP-style ready hooks; T3, arXiv:2401.16677).

Leaves may be torch tensors (on any device), numpy arrays or Python
scalars; each comes back as its own kind, a torch leaf on its own
device.  Every call records per-bucket stats (pack / transfer /
collective / unpack seconds, wire bytes, overlap fraction) into the
owning group's ``_fusion_stats`` — surfaced via
``collective.fusion_stats()``, the same stats idiom
``DataIterator.stats()["device_feed"]`` established.
"""

from __future__ import annotations

import functools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

DEFAULT_BUCKET_BYTES = 4 << 20          # 4 MiB

#: Elements per int8 quantization block: one float32 scale per block,
#: so the sidecar adds 4/QUANT_BLOCK bytes per element (~1.6% at 256).
QUANT_BLOCK = 256

#: Reduce ops whose cross-rank combine survives blockwise int8
#: round-tripping (dequantize → accumulate at f32).  MIN/MAX/PRODUCT
#: fall back to unquantized transport.
_QUANT_OK_OPS = ("sum", "average")


def resolve_dtype(name: str):
    """The torch dtype named ``name`` (numpy's name for it: "float32",
    "bfloat16", "int64", "bool", ...)."""
    import torch  # noqa: PLC0415

    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {name!r}")
    return dtype


@functools.lru_cache(maxsize=None)
def _dtype_info(name: str) -> tuple:
    """(itemsize, is a float) of the dtype named ``name``."""
    dtype = resolve_dtype(name)
    return dtype.itemsize, dtype.is_floating_point


def _as_tensor(leaf):
    """A leaf as a torch tensor, without a copy where one is not needed:
    a tensor stays where it is, anything else becomes a CPU tensor."""
    import torch  # noqa: PLC0415

    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


# ----------------------------------------------------------------- plan

@dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its bucket."""

    leaf_index: int
    offset: int                          # element offset into the bucket
    size: int                            # element count
    shape: tuple
    dtype: str


@dataclass(frozen=True)
class Bucket:
    """One flat dtype-homogeneous buffer."""

    dtype: str                           # logical (leaf) dtype
    transport_dtype: str                 # wire dtype (== dtype unless cast)
    size: int                            # total elements
    slots: tuple                         # tuple[LeafSlot, ...]


@dataclass(frozen=True)
class CoalescedPlan:
    buckets: tuple                       # tuple[Bucket, ...]
    n_leaves: int
    total_bytes: int


def leaf_signature(leaves) -> tuple:
    """Hashable (shape, dtype) signature of a leaf list — the plan
    cache key component.  Reads ``.shape``/``.dtype`` attributes where
    present so device-resident leaves (CUDA tensors) are NOT copied to
    the host just to compute the key; dtype names normalize across
    frameworks ("torch.float32" → "float32")."""
    sig = []
    for leaf in leaves:
        dtype = getattr(leaf, "dtype", None)
        if dtype is None:
            arr = np.asarray(leaf)
            sig.append((arr.shape, str(arr.dtype)))
        else:
            sig.append((tuple(leaf.shape),
                        str(dtype).rsplit(".", 1)[-1]))
    return tuple(sig)


def _restore_leaf_type(like, t):
    """Match the naive verbs' type contract: a torch leaf comes back as
    a torch tensor on its own device, anything else as numpy."""
    import torch  # noqa: PLC0415

    if isinstance(like, torch.Tensor):
        return t if t.device == like.device else t.to(like.device)
    return t.cpu().numpy()


@functools.lru_cache(maxsize=128)
def _plan_for_signature(signature: tuple, bucket_bytes: int,
                        transport_dtype: str | None,
                        reverse: bool = False) -> CoalescedPlan:
    """Pack leaves (by signature) into dtype-segregated flat buckets.

    Leaves keep their input order within a dtype so unpack is a pure
    layout lookup; a leaf larger than ``bucket_bytes`` still gets
    exactly one (oversized) bucket — coalescing must never split a
    tensor across collectives.

    ``reverse=True`` assigns leaves to buckets in reverse input order
    (reverse-topological for a params pytree: backward produces the
    LAST leaves' grads first, so bucket 0 fills — and its collective
    can launch — earliest).  Slot offsets stay layout lookups either
    way; only the bucket membership/order changes.
    """
    by_dtype: dict[str, list] = {}
    ordered = reversed(range(len(signature))) if reverse \
        else range(len(signature))
    for index in ordered:
        shape, dtype = signature[index]
        by_dtype.setdefault(dtype, []).append((index, shape))

    buckets: list[Bucket] = []
    total_bytes = 0
    for dtype, entries in by_dtype.items():
        itemsize, is_float = _dtype_info(dtype)
        wire_dtype = dtype
        if transport_dtype and is_float and itemsize > 2:
            wire_dtype = transport_dtype
        budget = max(1, bucket_bytes // itemsize)
        slots: list[LeafSlot] = []
        offset = 0
        for index, shape in entries:
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if slots and offset + size > budget:
                buckets.append(Bucket(dtype, wire_dtype, offset,
                                      tuple(slots)))
                slots, offset = [], 0
            slots.append(LeafSlot(index, offset, size, tuple(shape), dtype))
            offset += size
            total_bytes += size * itemsize
        if slots:
            buckets.append(Bucket(dtype, wire_dtype, offset, tuple(slots)))
    return CoalescedPlan(tuple(buckets), len(signature), total_bytes)


def plan_buckets(leaves, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 transport_dtype: str | None = None, *,
                 reverse: bool = False) -> CoalescedPlan:
    return _plan_for_signature(leaf_signature(leaves), int(bucket_bytes),
                               transport_dtype, reverse)


def plan_buckets_per_level(leaves, topo, bucket_bytes: int =
                           DEFAULT_BUCKET_BYTES,
                           transport_dtype: str | None = None, *,
                           reverse: bool = False) -> dict:
    """Per-level plans for a hierarchical reduction: the intra-slice
    (ICI) hop packs at ``topo.ici_bucket_bytes`` and the cross-slice
    (DCN) leader exchange at ``topo.dcn_bucket_bytes`` (each defaulting
    to ``bucket_bytes``).  The ICI plan is the wire plan — pack/unpack
    layout and per-bucket launch granularity — while the DCN plan
    bounds how many ICI buckets the leader hop may batch per exchange
    (typically fewer, larger buckets: DCN round trips cost more than
    they stream)."""
    ici_bytes, dcn_bytes = topo.per_level_bucket_bytes(bucket_bytes)
    signature = leaf_signature(leaves)
    return {
        "ici": _plan_for_signature(signature, int(ici_bytes),
                                   transport_dtype, reverse),
        "dcn": _plan_for_signature(signature, int(dcn_bytes),
                                   transport_dtype, reverse),
    }


def plan_cache_info():
    return _plan_for_signature.cache_info()


# ------------------------------------------------- int8 wire quantization

def quant_blocks(size: int, block: int = QUANT_BLOCK) -> int:
    """Number of scale blocks covering ``size`` elements (final block
    may be odd-sized)."""
    return max(1, -(-size // block))


def quantize_blockwise(flat, block: int = QUANT_BLOCK) -> tuple:
    """float → (int8 codes, per-block float32 scales), torch tensors on
    ``flat``'s device.

    Each block of ``block`` elements is scaled by max(|x|)/127 so the
    widest element maps to ±127; an all-zero block keeps scale 1.0
    (codes are 0, avoiding 0-division on dequant).  The sidecar costs
    4/block bytes per element — ~1.6% at the default 256.  Every step
    is one IEEE float32 operation, rounding half to even, so the codes
    and scales are the JAX package's bytes on the same input."""
    import torch  # noqa: PLC0415

    flat = _as_tensor(flat).reshape(-1).to(torch.float32)
    size = flat.numel()
    n_blocks = quant_blocks(size, block)
    padded = torch.zeros((n_blocks * block,), dtype=torch.float32,
                         device=flat.device)
    padded[:size] = flat
    grid = padded.view(n_blocks, block)
    scales = grid.abs().amax(dim=1) / 127.0
    scales = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(grid / scales[:, None]), -127, 127).to(
        torch.int8)
    return q.reshape(-1)[:size], scales


def dequantize_blockwise(q, scales, block: int = QUANT_BLOCK):
    """(int8 codes, per-block scales) → float32 values, on the codes'
    device."""
    import torch  # noqa: PLC0415

    q = _as_tensor(q).reshape(-1)
    scales = _as_tensor(scales).reshape(-1).to(torch.float32)
    expanded = torch.repeat_interleave(scales, block)[:q.numel()]
    return q.to(torch.float32) * expanded


def payload_nbytes(payload) -> int:
    """Wire bytes of a packed bucket payload (plain tensor or the
    int8 ``(codes, scales)`` pair)."""
    if isinstance(payload, tuple):
        return sum(payload_nbytes(p) for p in payload)
    return int(payload.numel() * payload.element_size())


def pack_bucket(bucket: Bucket, leaves):
    """Leaves → one contiguous flat tensor in the bucket's wire dtype,
    on the device of the bucket's first leaf (a CUDA bucket is packed
    on the card).

    The transport cast (e.g. float32→bfloat16) happens HERE, once — that
    is the lossy step; the reduction itself accumulates at float32 (see
    the backend paths).  An ``int8`` transport bucket returns the
    ``(codes, scales)`` pair from :func:`quantize_blockwise` instead of
    a single tensor."""
    import torch  # noqa: PLC0415

    quantized = bucket.transport_dtype == "int8"
    pack_dtype = (torch.float32 if quantized
                  else resolve_dtype(bucket.transport_dtype))
    parts = [_as_tensor(leaves[slot.leaf_index])
             for slot in bucket.slots]
    flat = torch.empty((bucket.size,), dtype=pack_dtype,
                       device=parts[0].device)
    for slot, part in zip(bucket.slots, parts):
        flat[slot.offset:slot.offset + slot.size].copy_(part.reshape(-1))
    if quantized:
        return quantize_blockwise(flat)
    return flat


def unpack_bucket(bucket: Bucket, flat, out: list, like=None) -> None:
    """Reduced flat tensor → per-leaf tensors (leaf dtype restored) into
    ``out`` at each slot's original pytree position.  With ``like``
    (the input leaves) the flat tensor first moves, once, to the device
    of the bucket's first leaf."""
    import torch  # noqa: PLC0415

    flat = _as_tensor(flat)
    if like is not None:
        home = like[bucket.slots[0].leaf_index]
        if isinstance(home, torch.Tensor) and flat.device != home.device:
            flat = flat.to(home.device)
    leaf_dtype = resolve_dtype(bucket.dtype)
    for slot in bucket.slots:
        piece = flat[slot.offset:slot.offset + slot.size]
        out[slot.leaf_index] = piece.to(leaf_dtype).reshape(slot.shape)


# ------------------------------------------------------------- pipeline

class PipelinedRunner:
    """Two-stage pipeline over an item list: ``prepare`` (pack +
    transfer issue) for item k+1 overlaps ``collective`` for item k.

    ``prepare_fn(item, index)`` runs on a producer thread feeding a
    bounded queue (depth 1 = classic double buffering); the caller's
    thread drains it through ``collective_fn(staged, index)``.  With
    ``overlap=False`` both stages run inline — the naive baseline.

    ``clock`` is injectable (tests drive a logical counter — no
    wall-clock flakiness); every stage edge is appended to ``events``
    as ``(stage_edge, index, tick)`` and :meth:`overlap_seconds`
    integrates prepare∩collective window intersections.
    """

    def __init__(self, prepare_fn, collective_fn, *, overlap: bool = True,
                 depth: int = 1, clock=time.perf_counter):
        self._prepare = prepare_fn
        self._collective = collective_fn
        self._overlap = overlap
        self._depth = max(1, depth)
        self._clock = clock
        self._lock = threading.Lock()
        self.events: list = []

    def _mark(self, edge: str, index: int) -> None:
        with self._lock:
            self.events.append((edge, index, self._clock()))

    def _staged_prepare(self, item, index: int):
        self._mark("prepare_start", index)
        try:
            return self._prepare(item, index)
        finally:
            self._mark("prepare_end", index)

    def _run_collective(self, staged, index: int):
        self._mark("collective_start", index)
        try:
            return self._collective(staged, index)
        finally:
            self._mark("collective_end", index)

    def run(self, items) -> list:
        items = list(items)
        if not items:
            return []
        if not self._overlap or len(items) == 1:
            return [self._run_collective(self._staged_prepare(item, k), k)
                    for k, item in enumerate(items)]

        q: _queue.Queue = _queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def produce():
            for k, item in enumerate(items):
                try:
                    staged = ("item", self._staged_prepare(item, k))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    staged = ("error", e)
                while not stop.is_set():
                    try:
                        q.put(staged, timeout=0.05)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set() or staged[0] == "error":
                    return

        producer = threading.Thread(target=produce, daemon=True,
                                    name="coalesced-prepare")
        producer.start()
        results = []
        try:
            for k in range(len(items)):
                kind, staged = q.get()
                if kind == "error":
                    raise staged
                results.append(self._run_collective(staged, k))
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            producer.join(timeout=5.0)
        return results

    # ---- stats

    def _windows(self, stage: str) -> list:
        starts: dict[int, float] = {}
        spans = []
        for edge, index, tick in self.events:
            if edge == f"{stage}_start":
                starts[index] = tick
            elif edge == f"{stage}_end" and index in starts:
                spans.append((starts.pop(index), tick))
        return spans

    def overlap_seconds(self) -> float:
        """Total prepare time spent inside some collective window."""
        collectives = self._windows("collective")
        overlapped = 0.0
        for p0, p1 in self._windows("prepare"):
            for c0, c1 in collectives:
                overlapped += max(0.0, min(p1, c1) - max(p0, c0))
        return overlapped

    def stage_seconds(self, stage: str) -> float:
        return sum(t1 - t0 for t0, t1 in self._windows(stage))


# ------------------------------------------------------------ execution

@dataclass
class FusionStats:
    """Cumulative per-group fusion counters (device_feed stats idiom).

    ``wire_bytes`` is what actually crossed the wire (post transport
    cast / quantization, sidecar scales included) vs ``bytes`` which is
    the logical leaf payload.  ``dcn_participants`` counts ranks that
    took part in a cross-slice (DCN) exchange, cumulative per bucket
    collective: a flat allreduce adds world_size, the hierarchical path
    adds num_slices — their ratio is the hierarchy's win.
    ``overlap_s`` is collective time hidden under concurrent pack/
    transfer (pipelined path) or remaining backward compute
    (:class:`GradientSyncer`); ``overlap_fraction`` is the hidden share
    of total collective time."""

    calls: int = 0
    tensors: int = 0
    buckets: int = 0
    bytes: int = 0
    wire_bytes: int = 0
    dcn_participants: int = 0
    pack_s: float = 0.0
    transfer_s: float = 0.0
    collective_s: float = 0.0
    unpack_s: float = 0.0
    overlap_s: float = 0.0
    plan_cache_hits: int = 0
    last: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "calls": self.calls,
            "tensors": self.tensors,
            "buckets": self.buckets,
            "bytes": self.bytes,
            "wire_bytes": self.wire_bytes,
            "wire_ratio": (self.wire_bytes / self.bytes
                           if self.bytes > 0 else 1.0),
            "dcn_participants": self.dcn_participants,
            "pack_s": self.pack_s,
            "transfer_s": self.transfer_s,
            "collective_s": self.collective_s,
            "unpack_s": self.unpack_s,
            "overlap_s": self.overlap_s,
            "overlap_fraction": (min(1.0, self.overlap_s
                                     / self.collective_s)
                                 if self.collective_s > 0 else 0.0),
            "plan_cache_hits": self.plan_cache_hits,
            "last": dict(self.last),
        }


def effective_transport(opts) -> str | None:
    """The transport dtype actually usable for this reduce op: int8's
    dequantize-then-accumulate combine only composes for SUM/AVERAGE
    (MIN/MAX/PRODUCT fall back to unquantized transport)."""
    transport = opts.transport_dtype
    if transport == "int8":
        op = getattr(opts.reduce_op, "value", str(opts.reduce_op))
        if op not in _QUANT_OK_OPS:
            return None
    return transport


def run_coalesced(tensors, opts, *, transfer_fn, collective_fn,
                  stats: FusionStats | None = None) -> list:
    """Shared engine for the backend ``allreduce_coalesced`` verbs.

    ``transfer_fn(flat, bucket)`` stages a packed bucket toward the
    backend (to the host for gloo, to the group's card for nccl) — it
    runs on the pipeline's producer thread so bucket k+1's transfer
    overlaps bucket k's collective.  ``collective_fn(staged, bucket)``
    performs one fused reduction and returns the reduced flat tensor,
    wherever it lies: unpack moves it back to its leaves' device.
    """
    tensors = list(tensors)
    if not tensors:
        return []
    transport = effective_transport(opts)
    hits_before = _plan_for_signature.cache_info().hits
    topo = getattr(opts, "hierarchy", None)
    level_buckets = None
    if topo is not None and (topo.ici_bucket_bytes
                             or topo.dcn_bucket_bytes):
        # Hierarchical with per-level budgets: the ICI plan IS the
        # wire plan (pack layout + intra-slice launch granularity);
        # the coarser DCN plan is recorded so the leader hop's
        # batching headroom is visible in stats.
        levels = plan_buckets_per_level(tensors, topo,
                                        opts.bucket_bytes, transport)
        plan = levels["ici"]
        level_buckets = {"ici": len(levels["ici"].buckets),
                         "dcn": len(levels["dcn"].buckets)}
    else:
        plan = plan_buckets(tensors, opts.bucket_bytes, transport)
    plan_hit = _plan_for_signature.cache_info().hits > hits_before

    timings = {"pack_s": 0.0, "transfer_s": 0.0, "collective_s": 0.0}
    wire = {"bytes": 0}
    lock = threading.Lock()

    def prepare(bucket: Bucket, _index: int):
        t0 = time.perf_counter()
        flat = pack_bucket(bucket, tensors)
        t1 = time.perf_counter()
        staged = transfer_fn(flat, bucket)
        t2 = time.perf_counter()
        with lock:
            timings["pack_s"] += t1 - t0
            timings["transfer_s"] += t2 - t1
            wire["bytes"] += payload_nbytes(flat)
        return bucket, staged

    def reduce_one(staged, _index: int):
        bucket, payload = staged
        t0 = time.perf_counter()
        out = collective_fn(payload, bucket)
        with lock:
            timings["collective_s"] += time.perf_counter() - t0
        return bucket, out

    runner = PipelinedRunner(prepare, reduce_one, overlap=opts.overlap)
    reduced = runner.run(plan.buckets)

    t0 = time.perf_counter()
    out: list = [None] * plan.n_leaves
    for bucket, flat in reduced:
        unpack_bucket(bucket, flat, out, tensors)
    out = [_restore_leaf_type(leaf, arr)
           for leaf, arr in zip(tensors, out)]
    unpack_s = time.perf_counter() - t0

    if stats is not None:
        overlap_s = runner.overlap_seconds()
        last = {
            "tensors": plan.n_leaves,
            "buckets": len(plan.buckets),
            "bytes": plan.total_bytes,
            "wire_bytes": wire["bytes"],
            "transport_dtype": transport or "",
            "plan_cache_hit": plan_hit,
            "overlap_s": overlap_s,
            "unpack_s": unpack_s,
            **timings,
        }
        if level_buckets is not None:
            last["level_buckets"] = level_buckets
        stats.calls += 1
        stats.tensors += plan.n_leaves
        stats.buckets += len(plan.buckets)
        stats.bytes += plan.total_bytes
        stats.wire_bytes += wire["bytes"]
        stats.pack_s += timings["pack_s"]
        stats.transfer_s += timings["transfer_s"]
        stats.collective_s += timings["collective_s"]
        stats.unpack_s += unpack_s
        stats.overlap_s += overlap_s
        stats.plan_cache_hits += int(plan_hit)
        stats.last = last
    return out


# ----------------------------------------------------- gradient overlap

class GradientSyncer:
    """DDP-style gradient-ready overlap over a collective group.

    ``begin(template)`` plans buckets from the grads pytree in
    *reverse* leaf order (backward produces the last layers' grads
    first, so bucket 0 completes earliest) and starts a worker thread
    that processes buckets strictly in plan order: wait until every
    leaf of bucket k is marked ready, pack, stage the transfer, run the
    collective.  The fixed order keeps cross-rank launch order
    deterministic — every rank reduces bucket k before bucket k+1 —
    while bucket k's wire time hides under the compute still producing
    bucket k+1's leaves.

    The caller marks leaves via ``ready(leaf_index, grad)`` as backward
    materializes them (leaf indices follow ``flatten_pytree`` order)
    and collects the reduced pytree with ``wait()``.  In torch a leaf's
    ready moment is its parameter's
    ``Tensor.register_post_accumulate_grad_hook``: the hook runs once
    the parameter's ``.grad`` holds its whole gradient for the step, and
    calls ``ready(i, param.grad)``.  The worker thread packs on the
    gradients' device, so a bucket of CUDA gradients is packed on the
    card while backward goes on.  ``sync(tree)`` is
    the one-shot degenerate case: every leaf is ready up front, so it
    behaves like ``allreduce_coalesced`` with reverse bucket order —
    the signature ``train.sync_gradients`` keeps.

    Overlap accounting rides the :class:`PipelinedRunner` tick
    machinery (``_mark`` / ``_windows`` with an injectable clock): the
    compute window spans ``begin()`` → ``wait()`` entry, and collective
    time inside it was hidden under backward — fed into the group's
    ``FusionStats.overlap_s`` and the ``overlap_fraction`` the step
    profiler and ``art_train_step_phase_fraction{collective}`` gauge
    consume.
    """

    def __init__(self, group, opts, *, clock=time.perf_counter):
        self._group = group
        self._opts = opts
        self._clock = clock
        self._state: dict | None = None

    # ------------------------------------------------------------ begin

    def begin(self, template) -> "GradientSyncer":
        """Plan buckets from ``template`` (the grads pytree — shapes
        and dtypes are read, values ignored) and start the bucket
        worker.  One sync may be in flight at a time."""
        if self._state is not None:
            raise RuntimeError("a gradient sync is already in flight; "
                               "call wait() first")
        leaves, treedef = flatten_pytree(template)
        transport = effective_transport(self._opts)
        hits_before = _plan_for_signature.cache_info().hits
        plan = plan_buckets(leaves, self._opts.bucket_bytes, transport,
                            reverse=True)
        plan_hit = _plan_for_signature.cache_info().hits > hits_before
        bucket_of = {}
        remaining = []
        for bi, bucket in enumerate(plan.buckets):
            remaining.append(len(bucket.slots))
            for slot in bucket.slots:
                bucket_of[slot.leaf_index] = bi
        runner = PipelinedRunner(None, None, clock=self._clock)
        state = {
            "plan": plan, "treedef": treedef, "plan_hit": plan_hit,
            "leaves": leaves, "values": list(leaves),
            "bucket_of": bucket_of, "remaining": remaining,
            "bucket_ready": [threading.Event() for _ in plan.buckets],
            "reduced": [None] * len(plan.buckets),
            "wire_bytes": 0, "error": None,
            "runner": runner, "lock": threading.Lock(),
            "timings": {"pack_s": 0.0, "transfer_s": 0.0,
                        "collective_s": 0.0},
        }
        runner._mark("compute_start", 0)
        thread = threading.Thread(target=self._drain, args=(state,),
                                  daemon=True, name="gradient-syncer")
        state["thread"] = thread
        self._state = state
        thread.start()
        return self

    def _drain(self, state: dict) -> None:
        runner: PipelinedRunner = state["runner"]
        timings = state["timings"]
        try:
            for bi, bucket in enumerate(state["plan"].buckets):
                state["bucket_ready"][bi].wait()
                t0 = time.perf_counter()
                runner._mark("prepare_start", bi)
                flat = pack_bucket(bucket, state["values"])
                t1 = time.perf_counter()
                staged = self._group.bucket_transfer(flat, bucket,
                                                     self._opts)
                runner._mark("prepare_end", bi)
                t2 = time.perf_counter()
                runner._mark("collective_start", bi)
                out = self._group.bucket_reduce(staged, bucket,
                                                self._opts)
                runner._mark("collective_end", bi)
                t3 = time.perf_counter()
                with state["lock"]:
                    timings["pack_s"] += t1 - t0
                    timings["transfer_s"] += t2 - t1
                    timings["collective_s"] += t3 - t2
                    state["wire_bytes"] += payload_nbytes(flat)
                state["reduced"][bi] = out
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            state["error"] = e

    # ------------------------------------------------------------ ready

    def ready(self, leaf_index: int, grad=None) -> None:
        """Mark one leaf's gradient as materialized (optionally
        replacing the template's value).  When a bucket's last leaf
        arrives its collective becomes eligible immediately."""
        state = self._state
        if state is None:
            raise RuntimeError("no gradient sync in flight; call begin()")
        bi = state["bucket_of"].get(leaf_index)
        if bi is None:
            raise IndexError(f"leaf index {leaf_index} is not in the plan")
        with state["lock"]:
            if grad is not None:
                state["values"][leaf_index] = grad
            state["remaining"][bi] -= 1
            fire = state["remaining"][bi] == 0
        if fire:
            state["bucket_ready"][bi].set()

    def wait(self):
        """Block until every bucket reduced; unpack and return the
        synced pytree.  Collective windows that closed before this call
        were fully hidden under backward compute."""
        state = self._state
        if state is None:
            raise RuntimeError("no gradient sync in flight; call begin()")
        runner: PipelinedRunner = state["runner"]
        runner._mark("compute_end", 0)
        state["thread"].join()
        self._state = None
        if state["error"] is not None:
            raise state["error"]

        plan: CoalescedPlan = state["plan"]
        t0 = time.perf_counter()
        out: list = [None] * plan.n_leaves
        for bucket, flat in zip(plan.buckets, state["reduced"]):
            unpack_bucket(bucket, flat, out, state["leaves"])
        out = [_restore_leaf_type(leaf, arr)
               for leaf, arr in zip(state["leaves"], out)]
        unpack_s = time.perf_counter() - t0

        compute = runner._windows("compute")
        overlap_s = 0.0
        for c0, c1 in runner._windows("collective"):
            for w0, w1 in compute:
                overlap_s += max(0.0, min(c1, w1) - max(c0, w0))
        stats = getattr(self._group, "_fusion_stats", None)
        if stats is None:
            stats = self._group._fusion_stats = FusionStats()
        timings = state["timings"]
        stats.calls += 1
        stats.tensors += plan.n_leaves
        stats.buckets += len(plan.buckets)
        stats.bytes += plan.total_bytes
        stats.wire_bytes += state["wire_bytes"]
        stats.pack_s += timings["pack_s"]
        stats.transfer_s += timings["transfer_s"]
        stats.collective_s += timings["collective_s"]
        stats.unpack_s += unpack_s
        stats.overlap_s += overlap_s
        stats.plan_cache_hits += int(state["plan_hit"])
        stats.last = {
            "tensors": plan.n_leaves, "buckets": len(plan.buckets),
            "bytes": plan.total_bytes,
            "wire_bytes": state["wire_bytes"],
            "transport_dtype": effective_transport(self._opts) or "",
            "plan_cache_hit": state["plan_hit"],
            "overlap_s": overlap_s, "unpack_s": unpack_s,
            "collective_s_clock": runner.stage_seconds("collective"),
            **timings,
        }
        return unflatten_pytree(state["treedef"], out)

    # --------------------------------------------------------- one-shot

    def sync(self, tree):
        """One-shot sync: every leaf is already materialized — the
        degenerate case with reverse bucket order and identical
        numerics to the hook-driven path."""
        self.begin(tree)
        state = self._state
        for leaf_index in reversed(range(len(state["leaves"]))):
            self.ready(leaf_index)
        return self.wait()


# -------------------------------------------------------------- pytree

def flatten_pytree(tree):
    """Deterministic flatten for dict/list/tuple pytrees: dict keys in
    sorted order, as ``jax.tree_util`` flattens them, so both packages
    see the same leaves in the same order.  Anything that is not a
    dict, list or tuple is a leaf.  (Module-level recursion, not a
    nested closure: a recursive closure is a reference cycle, which
    would keep the leaves — CUDA memory — alive until the next garbage
    collection.)"""
    leaves: list = []
    return leaves, ("py", _walk(tree, leaves))


def _walk(node, leaves: list):
    if isinstance(node, dict):
        return ("dict", [(k, _walk(node[k], leaves)) for k in sorted(node)])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, [_walk(v, leaves) for v in node])
    leaves.append(node)
    return ("leaf", len(leaves) - 1)


def unflatten_pytree(treedef, leaves):
    _kind, spec = treedef
    return _build(spec, leaves)


def _build(node, leaves):
    tag, payload = node
    if tag == "dict":
        return {k: _build(v, leaves) for k, v in payload}
    if tag == "list":
        return [_build(v, leaves) for v in payload]
    if tag == "tuple":
        return tuple(_build(v, leaves) for v in payload)
    return leaves[payload]
