"""NCCL collective group — the counterpart of the JAX package's
``collective_group/xla_group.py`` (ref: python/ray/util/collective/
collective_group/nccl_collective_group.py).

Design: the group builds its own NCCL process group
(``torch.distributed.ProcessGroupNCCL``) over a store met through the
GCS KV (``gloo_group.rendezvous_store``: rank 0 binds, then
advertises), and drives it through the process group's own methods.  It
never touches torch's default process group, which a gloo group takes,
so a process can hold one group of each.  Tensors are reduced on the
group's card (the current CUDA device unless ``device=`` names one): a
CPU tensor or a numpy array is copied there and its result back.

* the per-rank verbs and the fused bucket path (``allreduce_coalesced``,
  ``bucket_transfer`` / ``bucket_reduce``) are the shared ones of
  ``torch_group.py``, with buckets packed, reduced and unpacked on the
  card — the int8 transport (codes and scales gathered, dequantized and
  summed at float32 on the card) is the counterpart of ``_compile_q8``,
  the two-level schedule over per-slice and leader subgroups the
  counterpart of ``_compile_hierarchical``;
* ``reducescatter`` is NCCL's reduce-scatter;
* ``send`` / ``recv`` are NCCL point-to-point (the reference's xla
  group mails through the GCS KV instead);
* the ``*_multidevice`` verbs (parity with the reference's
  ``*_multigpu``) run over every card this process sees, one tensor a
  card, through ``torch.cuda.nccl``.

There is no fallback: without CUDA, without NCCL in the torch build, or
when NCCL fails to initialise, making the group raises, naming the
cause.  NCCL refuses two ranks of one group on one card."""

from __future__ import annotations

import logging

from ant_ray_tpu_torch.util.collective import types
from ant_ray_tpu_torch.util.collective.collective_group.gloo_group import (
    forget_rendezvous,
    rendezvous_store,
)
from ant_ray_tpu_torch.util.collective.collective_group.torch_group import (
    TorchDistGroup,
    _c10d_op,
    _dist,
    _divide,
)

logger = logging.getLogger(__name__)

# torch.cuda.nccl's reduce-op codes (ncclRedOp_t).
_NCCL_OPS = {types.ReduceOp.SUM: 0, types.ReduceOp.AVERAGE: 0,
             types.ReduceOp.PRODUCT: 1, types.ReduceOp.MAX: 2,
             types.ReduceOp.MIN: 3}


class NCCLGroup(TorchDistGroup):
    def __init__(self, world_size: int, rank: int, group_name: str,
                 store=None, device=None):
        super().__init__(world_size, rank, group_name)
        import torch  # noqa: PLC0415

        dist = _dist()
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"nccl group {group_name!r} needs a CUDA device, and "
                "torch.cuda.is_available() is False in this process; "
                "an NCCL group is never made over gloo instead (use "
                "backend='gloo' for CPU tensors)")
        if not dist.is_nccl_available():
            raise RuntimeError(
                f"nccl group {group_name!r}: this torch build "
                f"({torch.__version__}) has no NCCL")
        self._wire = (torch.device(device) if device is not None
                      else torch.device("cuda", torch.cuda.current_device()))
        self._store = store if store is not None else rendezvous_store(
            group_name, rank, world_size, "nccl")
        self._subgroups: list = []
        self._pg = self._make_pg("world", rank, world_size)
        try:
            # NCCL builds its communicator on the first collective:
            # build it now, so a failure surfaces here, named.
            self._all_reduce(torch.zeros(1, device=self._wire),
                             types.ReduceOp.SUM)
            torch.cuda.synchronize(self._wire)
        except Exception as e:
            self._shutdown_pgs()
            raise RuntimeError(
                f"NCCL failed to initialise group {group_name!r} (rank "
                f"{rank} of {world_size} on {self._wire}): {e}") from e

    @classmethod
    def backend(cls):
        return "nccl"

    def _make_pg(self, tag: str, rank: int, size: int):
        import torch  # noqa: PLC0415

        dist = _dist()
        with torch.cuda.device(self._wire):
            pg = dist.ProcessGroupNCCL(
                dist.PrefixStore(f"{self._group_name}/{tag}", self._store),
                rank, size, dist.ProcessGroupNCCL.Options())
        self._subgroups.append(pg)
        return pg

    def _new_subgroup(self, ranks: list, tag: str):
        if self._rank not in ranks:
            return None
        return self._make_pg(tag, ranks.index(self._rank), len(ranks))

    def _shutdown_pgs(self):
        for pg in self._subgroups:
            for name in ("shutdown", "abort"):
                fn = getattr(pg, name, None)
                if fn is not None:
                    try:
                        fn()
                    except Exception as e:  # noqa: BLE001 — teardown
                        logger.debug("nccl %s of %s: %s", name,
                                     self._group_name, e)
                    break
        self._subgroups = []
        self._pg = None

    def destroy_group(self):
        self._shutdown_pgs()
        self._hier_cache.clear()
        if self._rank == 0 and self._world_size > 1:
            forget_rendezvous(self._group_name, "nccl")

    @property
    def destroyed(self) -> bool:
        return self._pg is None

    def barrier(self, opts: types.BarrierOptions):
        dist = _dist()
        bopts = dist.BarrierOptions()
        bopts.device_ids = [self._wire.index]
        self._pg.barrier(bopts).wait()

    def reducescatter(self, tensors, opts: types.ReduceScatterOptions):
        """NCCL's reduce-scatter: this rank's slice of dim 0 of the
        reduction."""
        import torch  # noqa: PLC0415

        dist = _dist()
        t, origin = self._stage(tensors[0])
        self._check_scatter(t)
        chunk = t.shape[0] // self._world_size
        out = torch.empty_like(t[:chunk])
        ropts = dist.ReduceScatterOptions()
        ropts.reduceOp = _c10d_op(opts.reduce_op)
        self._pg.reduce_scatter([out], [list(t.split(chunk))], ropts).wait()
        if opts.reduce_op == types.ReduceOp.AVERAGE:
            _divide(out, self._world_size)
        return [self._unstage(out, origin, fresh=True)]

    def send(self, tensors, opts: types.SendOptions):
        if opts.dst_rank == self._rank:
            raise ValueError("nccl send: a rank cannot send to itself")
        super().send(tensors, opts)

    def recv(self, tensors, opts: types.RecvOptions):
        if opts.src_rank == self._rank:
            raise ValueError("nccl recv: a rank cannot receive from itself")
        return super().recv(tensors, opts)

    # ---- multi-device variants (parity: reference *_multigpu verbs)

    def _local_tensors(self, tensors: list) -> list:
        """One CUDA tensor on each card this process sees, in device
        order."""
        import torch  # noqa: PLC0415

        n = torch.cuda.device_count()
        devices = [getattr(t, "device", None) for t in tensors]
        if len(tensors) != n or sorted(
                d.index for d in devices if d is not None and
                d.type == "cuda") != list(range(n)):
            raise ValueError(
                f"expected one CUDA tensor per visible card ({n}), got "
                f"{[str(d) for d in devices]}")
        return sorted(tensors, key=lambda t: t.device.index)

    @property
    def local_device_count(self) -> int:
        import torch  # noqa: PLC0415

        return torch.cuda.device_count()

    def allreduce_multidevice(self, tensors: list,
                              opts: types.AllReduceOptions):
        from torch.cuda import nccl  # noqa: PLC0415

        tensors = self._local_tensors(tensors)
        outs = [t.clone() for t in tensors]
        nccl.all_reduce(outs, op=_NCCL_OPS[opts.reduce_op])
        if opts.reduce_op == types.ReduceOp.AVERAGE:
            for out in outs:
                _divide(out, len(outs))
        return outs

    def broadcast_multidevice(self, tensors: list,
                              opts: types.BroadcastOptions):
        from torch.cuda import nccl  # noqa: PLC0415

        outs = [t.clone() for t in self._local_tensors(tensors)]
        nccl.broadcast(outs, root=opts.root_rank)
        return outs

    def allgather_multidevice(self, tensors: list,
                              opts: types.AllGatherOptions):
        import torch  # noqa: PLC0415
        from torch.cuda import nccl  # noqa: PLC0415

        tensors = self._local_tensors(tensors)
        n = len(tensors)
        outs = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                            device=t.device) for t in tensors]
        nccl.all_gather([t.contiguous() for t in tensors], outs)
        return [list(out.unbind(0)) for out in outs]

    def reducescatter_multidevice(self, tensors: list,
                                  opts: types.ReduceScatterOptions):
        import torch  # noqa: PLC0415
        from torch.cuda import nccl  # noqa: PLC0415

        tensors = self._local_tensors(tensors)
        n = len(tensors)
        if tensors[0].shape[0] % n != 0:
            raise ValueError(
                f"reducescatter leading dim {tensors[0].shape[0]} not "
                f"divisible by group size {n}")
        chunk = tensors[0].shape[0] // n
        outs = [torch.empty_like(t[:chunk]) for t in tensors]
        nccl.reduce_scatter([t.contiguous() for t in tensors], outs,
                            op=_NCCL_OPS[opts.reduce_op])
        if opts.reduce_op == types.ReduceOp.AVERAGE:
            for out in outs:
                _divide(out, n)
        return outs

