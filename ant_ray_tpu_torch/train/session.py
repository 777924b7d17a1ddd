"""In-worker training session: report() / get_context() / get_checkpoint()
(ref: train/v2/_internal/execution/train_fn_utils.py + session semantics),
a copy of the JAX package's ``train/session.py``: ``use_gpu`` in place of
``use_tpu``, and the gang's gradient-sync group NCCL on GPU gangs."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    storage_path: str = ""
    controller: Any = None              # ActorHandle of the controller
    latest_checkpoint: Any = None
    # Group-restart counter (0 on the first launch): lets user loops
    # derive attempt-unique rendezvous names so a restarted gang never
    # collides with its predecessor's collective group.
    attempt: int = 0
    # Whether this rank binds a GPU (picks the collective backend for
    # sync_gradients: nccl on GPU gangs, gloo on CPU gangs).
    use_gpu: bool = False
    # Rank→slice partition of the gang (collective.types.SliceTopology)
    # when the job spans multiple accelerator slices; sync_gradients
    # routes through the hierarchical intra-slice (ICI) / inter-slice
    # (DCN) allreduce when set.
    slice_topology: Any = None
    # name -> DataIterator for this rank (from the trainer's datasets=).
    dataset_shards: dict = field(default_factory=dict)
    # The loop's StepProfiler (observability/step_profiler.py) — it
    # registers itself here on construction, and report() auto-attaches
    # its latest step record for the controller's cross-rank gauges.
    step_profiler: Any = None
    _report_lock: threading.Lock = field(default_factory=threading.Lock)


class PreemptionInterrupt(BaseException):
    """Raised inside a train loop by :func:`report` when the controller
    has ordered a proactive drain stop (a node hosting the gang got a
    preemption/maintenance notice).  The checkpoint carried by that
    very report was already registered, so unwinding here loses zero
    steps — the controller relaunches the gang off the draining node
    and resumes from it.

    Derives from ``BaseException`` so a user loop's broad
    ``except Exception`` cannot swallow the drain; the worker shim
    (TrainWorker.run) catches it."""


_ctx = threading.local()


def _set_context(ctx: TrainContext) -> None:
    _ctx.value = ctx


def get_context() -> TrainContext:
    ctx = getattr(_ctx, "value", None)
    if ctx is None:
        raise RuntimeError(
            "No training context: this API is only available inside a "
            "train_loop_per_worker")
    return ctx


def report(metrics: dict, checkpoint=None) -> None:
    """Report metrics (and optionally a checkpoint) to the controller
    (ref: ray.train.report).  Blocks until the controller acknowledged, so
    checkpoint ordering is deterministic.

    A pytree checkpoint's torch tensors are copied to the host before
    they leave the rank: the controller, which saves it, holds no card.

    When the loop runs a :class:`~ant_ray_tpu_torch.observability.StepProfiler`,
    the latest step record rides along (``_step_record``) — the
    controller folds every rank's records into step-time and
    rank-skew gauges, and the profiler's publish buffer is flushed so
    the timeline's device rows stay current."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    ctx = get_context()
    metrics = dict(metrics)
    prof = ctx.step_profiler
    if prof is not None and "_step_record" not in metrics:
        last = prof.last
        if last is not None:
            metrics["_step_record"] = last.as_dict()
        prof.flush()
    if checkpoint is not None and not _is_checkpoint_handle(checkpoint):
        checkpoint = _to_host(checkpoint)
    with ctx._report_lock:
        reply = art.get(ctx.controller.report_from_worker.remote(
            ctx.world_rank, metrics, checkpoint))
    # The ack doubles as the drain channel: when the controller has a
    # preemption notice for this gang's node(s), it replies stop=True —
    # the checkpoint this report carried is already registered, so
    # unwinding NOW is the zero-step-loss exit point.
    if isinstance(reply, dict) and reply.get("stop"):
        raise PreemptionInterrupt


def get_dataset_shard(name: str = "train", device_feed: dict | None = None):
    """This rank's streaming DataIterator for the trainer's
    ``datasets={name: ds}`` (ref: train/_internal/session.py:1134).
    Split datasets are coordinated streaming shards (one pass of the
    plan per epoch, shared across ranks); broadcast datasets return a
    full-dataset iterator.

    The shard exposes ``iter_device_batches(...)`` — prefetched,
    double-buffered host→device batch delivery (data/device_feed.py) —
    preconfigured from ``DataConfig.device_feed`` by the controller.
    ``device_feed`` here overlays extra defaults from inside the loop
    (e.g. a sharding built on this worker's mesh)."""
    ctx = get_context()
    shard = ctx.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset {name!r} was passed to the trainer "
            f"(have: {sorted(ctx.dataset_shards)})")
    if device_feed:
        shard.configure_device_feed(**device_feed)
    return shard


def sync_gradients(grads, op=None, *, group_name: str | None = None,
                   **fusion_knobs):
    """Data-parallel gradient sync over the worker gang — fused
    bucketed allreduce by default (util/collective/fusion.py): the
    gradient pytree packs into 4 MiB flat buckets, one collective per
    bucket, bucket k+1's transfer pipelined against bucket k's
    collective.  Defaults to AVERAGE over ranks.

    The gang's collective group is created lazily on first call
    (attempt-unique name, so a restarted gang never collides with its
    predecessor's) — nccl backend on GPU gangs, gloo on CPU gangs.
    ``fusion_knobs`` forward to ``collective.sync_pytree``
    (``bucket_bytes``, ``transport_dtype``, ``overlap``,
    ``hierarchy``); when the gang spans multiple slices
    (``ScalingConfig.num_slices``), the context's slice topology is the
    default hierarchy.  World size 1 returns the
    pytree unchanged."""
    ctx = get_context()
    if ctx.world_size <= 1:
        return grads

    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415
    from ant_ray_tpu_torch.util.collective import ReduceOp  # noqa: PLC0415

    group = _ensure_gang_group(ctx, group_name)
    fusion_knobs.setdefault("hierarchy", ctx.slice_topology)
    return col.sync_pytree(grads, group_name=group,
                           op=ReduceOp.AVERAGE if op is None else op,
                           **fusion_knobs)


def _ensure_gang_group(ctx: TrainContext,
                       group_name: "str | None" = None) -> str:
    """Lazily create this gang's collective group (shared by
    sync_gradients and gradient_syncer) and wire its fusion stats into
    the step profiler."""
    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415

    group = group_name or (
        f"train-sync-{ctx.experiment_name or 'run'}-a{ctx.attempt}")
    if not col.is_group_initialized(group):
        col.init_collective_group(
            ctx.world_size, ctx.world_rank,
            backend="nccl" if ctx.use_gpu else "gloo", group_name=group)
        if ctx.step_profiler is not None:
            # The gang's fusion stats become the profiler's collective/
            # h2d phases — one attach per group lifetime (deltas).
            try:
                ctx.step_profiler.attach_fusion_stats(group)
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass
    return group


def gradient_syncer(op=None, *, group_name: str | None = None,
                    **fusion_knobs):
    """Ready-hook gradient sync for overlapping communication with the
    backward pass (util/collective/fusion.py GradientSyncer): leaves
    are assigned to buckets in reverse-topological order, and each
    bucket's collective launches the moment its last leaf
    materializes — call ``begin(template)`` once per step,
    ``ready(i, grad)`` as each leaf's gradient lands, and ``wait()``
    for the averaged pytree.  ``sync_gradients`` is the one-shot
    degenerate form.  Returns None at world size 1 (nothing to sync —
    callers fall back to their local gradients)."""
    ctx = get_context()
    if ctx.world_size <= 1:
        return None

    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415
    from ant_ray_tpu_torch.util.collective import ReduceOp  # noqa: PLC0415

    group = _ensure_gang_group(ctx, group_name)
    fusion_knobs.setdefault("hierarchy", ctx.slice_topology)
    return col.gradient_syncer(
        group, op=ReduceOp.AVERAGE if op is None else op,
        **fusion_knobs)


def get_checkpoint():
    """Latest checkpoint to resume from (set on restore/restart)."""
    return get_context().latest_checkpoint


def get_world_rank() -> int:
    return get_context().world_rank


def get_world_size() -> int:
    return get_context().world_size


def _is_checkpoint_handle(value) -> bool:
    from ant_ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: PLC0415

    return isinstance(value, Checkpoint)


def _to_host(tree):
    """``tree`` with every torch tensor that is not on the host copied
    there."""
    from ant_ray_tpu_torch.util.collective.fusion import (  # noqa: PLC0415
        flatten_pytree,
        unflatten_pytree,
    )

    leaves, treedef = flatten_pytree(tree)
    moved = [leaf.detach().cpu()
             if getattr(getattr(leaf, "device", None), "type", "cpu")
             != "cpu" else leaf for leaf in leaves]
    if all(a is b for a, b in zip(moved, leaves)):
        return tree
    return unflatten_pytree(treedef, moved)
