"""Base collective group interface (ref:
python/ray/util/collective/collective_group/base_collective_group.py), a
copy of the JAX package's ``collective_group/base.py``."""

from __future__ import annotations

from ant_ray_tpu_torch.util.collective import types


class BaseGroup:
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def group_name(self) -> str:
        return self._group_name

    @classmethod
    def backend(cls) -> str:
        raise NotImplementedError

    def destroy_group(self):
        pass

    # ---- collective verbs

    def allreduce(self, tensors, opts: types.AllReduceOptions):
        raise NotImplementedError

    def allreduce_coalesced(self, tensors,
                            opts: types.AllReduceCoalescedOptions):
        """Fused bucketed allreduce over a tensor list.  Backends
        without a fused path inherit this naive per-tensor loop, so
        the public API works (slowly) on any group."""
        out = []
        for tensor in tensors:
            out.append(self.allreduce(
                [tensor],
                types.AllReduceOptions(reduce_op=opts.reduce_op,
                                       timeout_ms=opts.timeout_ms))[0])
        return out

    def bucket_transfer(self, flat, bucket,
                        opts: types.AllReduceCoalescedOptions):
        """Stage one packed bucket payload toward the backend (the copy
        to the host for gloo, the card for nccl).  Exposed per
        bucket so both ``run_coalesced`` and the ready-hook
        ``GradientSyncer`` can drive single buckets."""
        raise NotImplementedError

    def bucket_reduce(self, staged, bucket,
                      opts: types.AllReduceCoalescedOptions):
        """Run one bucket's fused reduction on a staged payload and
        return the reduced flat buffer (accumulated at float32 for
        reduced-precision transports)."""
        raise NotImplementedError

    def fusion_stats(self) -> dict:
        """Cumulative fused-collective stats (device_feed idiom); the
        naive fallback has nothing to report."""
        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        stats = getattr(self, "_fusion_stats", None)
        if stats is None:
            stats = self._fusion_stats = fusion.FusionStats()
        return stats.as_dict()

    def barrier(self, opts: types.BarrierOptions):
        raise NotImplementedError

    def reduce(self, tensors, opts: types.ReduceOptions):
        raise NotImplementedError

    def broadcast(self, tensors, opts: types.BroadcastOptions):
        raise NotImplementedError

    def allgather(self, tensors, opts: types.AllGatherOptions):
        raise NotImplementedError

    def reducescatter(self, tensors, opts: types.ReduceScatterOptions):
        raise NotImplementedError

    def send(self, tensors, opts: types.SendOptions):
        raise NotImplementedError

    def recv(self, tensors, opts: types.RecvOptions):
        raise NotImplementedError
