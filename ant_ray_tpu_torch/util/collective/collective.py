"""Collective API — verb parity with the reference
(ref: python/ray/util/collective/collective.py — init_collective_group :171,
create_collective_group :211, ops :328-722), a copy of the JAX package's
``util/collective/collective.py`` whose ``xla`` backend is ``nccl`` here
(NCCL on CUDA tensors), beside ``gloo``.
"""

from __future__ import annotations

import logging
import threading

from ant_ray_tpu_torch.util.collective import types
from ant_ray_tpu_torch.util.collective.types import Backend, ReduceOp

logger = logging.getLogger(__name__)


class GroupManager:
    """Per-process registry of live collective groups
    (ref: collective.py:71)."""

    def __init__(self):
        self._groups: dict[str, object] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: str, world_size: int, rank: int,
                     group_name: str, **kwargs):
        backend = Backend.normalize(backend)
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(
                    f"collective group {group_name!r} already exists")
            if backend == Backend.NCCL:
                from ant_ray_tpu_torch.util.collective.collective_group import (  # noqa: PLC0415
                    nccl_group,
                )

                group = nccl_group.NCCLGroup(world_size, rank, group_name,
                                             store=kwargs.get("store"),
                                             device=kwargs.get("device"))
            else:
                from ant_ray_tpu_torch.util.collective.collective_group import (  # noqa: PLC0415
                    gloo_group,
                )

                group = gloo_group.GlooGroup(
                    world_size, rank, group_name,
                    init_method=kwargs.get("init_method"),
                    store=kwargs.get("store"))
            self._groups[group_name] = group
            return group

    def get_group(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise RuntimeError(
                f"collective group {group_name!r} is not initialized in "
                "this process; call init_collective_group first")
        return group

    def is_group_exist(self, group_name: str) -> bool:
        return group_name in self._groups

    def destroy_group(self, group_name: str):
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy_group()
        # A re-initialized group must start with a clean tensor-
        # transport slate: stale poisoned-pair markers from the old
        # incarnation would silently dma-degrade the new one forever.
        try:
            from ant_ray_tpu_torch.experimental import tensor_transport  # noqa: PLC0415

            tensor_transport.clear_group(group_name)
        except Exception:  # noqa: BLE001 — healing is best-effort
            pass


_group_mgr = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          backend: str = "nccl",
                          group_name: str = "default", **kwargs):
    """Initialize this process's membership of a collective group
    (ref: collective.py:171)."""
    if world_size <= 0 or not (0 <= rank < world_size):
        raise ValueError(f"invalid rank {rank} / world_size {world_size}")
    return _group_mgr.create_group(backend, world_size, rank, group_name,
                                   **kwargs)


def create_collective_group(actors, world_size: int, ranks: list[int],
                            backend: str = "nccl",
                            group_name: str = "default"):
    """Driver-side declarative group creation over actor handles
    (ref: collective.py:211).  Each actor must expose an
    ``init_collective_group(world_size, rank, backend, group_name)``
    method (mixin: :class:`CollectiveActorMixin`)."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks length mismatch")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(
            f"ranks must be a permutation of 0..{world_size - 1}")
    refs = [
        actor.init_collective_group.remote(world_size, rank, backend,
                                           group_name)
        for actor, rank in zip(actors, ranks)
    ]
    art.get(refs)


class CollectiveActorMixin:
    """Mix into actor classes to make them group-creatable from the driver."""

    def init_collective_group(self, world_size: int, rank: int,
                              backend: str = "nccl",
                              group_name: str = "default"):
        init_collective_group(world_size, rank, backend, group_name)
        return True

    def collective_rank(self, group_name: str = "default") -> int:
        return get_rank(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.is_group_exist(group_name)


def destroy_collective_group(group_name: str = "default"):
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).world_size


# ------------------------------------------------------------------- verbs

def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    return group.allreduce([tensor], types.AllReduceOptions(reduce_op=op))[0]


def allreduce_coalesced(tensors, group_name: str = "default",
                        op: ReduceOp = ReduceOp.SUM, *,
                        bucket_bytes: int = 4 << 20,
                        transport_dtype: "str | None" = None,
                        overlap: bool = True,
                        hierarchy: "types.SliceTopology | None" = None):
    """Fused bucketed allreduce over a list of tensors
    (util/collective/fusion.py): leaves pack into dtype-segregated
    flat buckets of at most ``bucket_bytes``, one collective runs per
    bucket, and bucket k+1's pack + host→device transfer overlaps
    bucket k's collective.  ``transport_dtype="bfloat16"`` opts wide
    float buckets into reduced-precision transport; ``"int8"`` ships
    blockwise-quantized codes + a float32 scale sidecar (~0.25x wire
    bytes, SUM/AVERAGE only; accumulation stays float32 either way).
    ``hierarchy`` (a :class:`~ant_ray_tpu_torch.util.collective.types.
    SliceTopology`) switches to the two-level intra-slice (ICI) /
    inter-slice (DCN) schedule.  Returns the reduced tensors in input
    order."""
    group = _group_mgr.get_group(group_name)
    return group.allreduce_coalesced(
        list(tensors),
        types.AllReduceCoalescedOptions(
            reduce_op=op, bucket_bytes=bucket_bytes,
            transport_dtype=transport_dtype, overlap=overlap,
            hierarchy=hierarchy))


def sync_pytree(tree, group_name: str = "default",
                op: ReduceOp = ReduceOp.AVERAGE, *,
                bucket_bytes: int = 4 << 20,
                transport_dtype: "str | None" = None,
                overlap: bool = True,
                hierarchy: "types.SliceTopology | None" = None):
    """Allreduce every leaf of a pytree through the fused bucketed
    path — the data-parallel gradient-sync verb.  Defaults to AVERAGE
    (gradient semantics); structure is preserved."""
    from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

    leaves, treedef = fusion.flatten_pytree(tree)
    reduced = allreduce_coalesced(
        leaves, group_name=group_name, op=op, bucket_bytes=bucket_bytes,
        transport_dtype=transport_dtype, overlap=overlap,
        hierarchy=hierarchy)
    return fusion.unflatten_pytree(treedef, reduced)


def gradient_syncer(group_name: str = "default",
                    op: ReduceOp = ReduceOp.AVERAGE, *,
                    bucket_bytes: int = 4 << 20,
                    transport_dtype: "str | None" = None,
                    hierarchy: "types.SliceTopology | None" = None,
                    clock=None):
    """A :class:`~ant_ray_tpu_torch.util.collective.fusion.GradientSyncer`
    bound to a live group: the ready-hook gradient sync that launches
    each bucket's collective the moment its last leaf materializes,
    overlapping communication with the rest of the backward pass.
    ``sync_pytree`` is its degenerate one-shot form."""
    import time  # noqa: PLC0415

    from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

    group = _group_mgr.get_group(group_name)
    opts = types.AllReduceCoalescedOptions(
        reduce_op=op, bucket_bytes=bucket_bytes,
        transport_dtype=transport_dtype, hierarchy=hierarchy)
    return fusion.GradientSyncer(
        group, opts, clock=clock if clock is not None
        else time.perf_counter)


def fusion_stats(group_name: str = "default") -> dict:
    """Cumulative fused-collective stats for a group (pack / transfer /
    collective seconds, overlap fraction — the device_feed stats
    idiom)."""
    return _group_mgr.get_group(group_name).fusion_stats()


def allreduce_multidevice(tensor_list, group_name: str = "default",
                          op: ReduceOp = ReduceOp.SUM):
    """One CUDA tensor per visible card (parity: allreduce_multigpu);
    NCCL groups only."""
    group = _group_mgr.get_group(group_name)
    return group.allreduce_multidevice(
        tensor_list, types.AllReduceOptions(reduce_op=op))


def barrier(group_name: str = "default"):
    _group_mgr.get_group(group_name).barrier(types.BarrierOptions())


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    return group.reduce(
        [tensor], types.ReduceOptions(reduce_op=op, root_rank=dst_rank))[0]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    return group.broadcast(
        [tensor], types.BroadcastOptions(root_rank=src_rank))[0]


def broadcast_multidevice(tensor_list, src_rank: int = 0,
                          group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    return group.broadcast_multidevice(
        tensor_list, types.BroadcastOptions(root_rank=src_rank))


def allgather(tensor, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    return group.allgather([tensor], types.AllGatherOptions())[0]


def allgather_multidevice(tensor_list, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    return group.allgather_multidevice(tensor_list,
                                       types.AllGatherOptions())


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    return group.reducescatter(
        [tensor], types.ReduceScatterOptions(reduce_op=op))[0]


def reducescatter_multidevice(tensor_list, group_name: str = "default",
                              op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    return group.reducescatter_multidevice(
        tensor_list, types.ReduceScatterOptions(reduce_op=op))


def send(tensor, dst_rank: int, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    group.send([tensor], types.SendOptions(dst_rank=dst_rank))


def recv(tensor, src_rank: int, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    return group.recv([tensor], types.RecvOptions(src_rank=src_rank))[0]
