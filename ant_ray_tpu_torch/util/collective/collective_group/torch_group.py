"""The verbs and the fused bucket path shared by the gloo and the NCCL
groups: both drive a ``torch.distributed`` process group (a c10d
``ProcessGroup`` or ``Backend``) through its own methods, and differ in
where a bucket lives while it is reduced (``_wire``: the host for gloo,
the group's card for NCCL) and in how a process group is made.

The bucket logic is the JAX package's gloo group's
(``collective_group/gloo_group.py``): flat, int8-quantized and two-level
(hierarchical) reductions, with AVERAGE taken as a SUM divided once by
the world size.  The hierarchy's subgroups are made by the subclass
(``_new_subgroup``); ranks inside a subgroup are its members' positions
in sorted order."""

from __future__ import annotations

from ant_ray_tpu_torch.util.collective import types
from ant_ray_tpu_torch.util.collective.collective_group.base import BaseGroup


def _dist():
    import torch.distributed as dist  # noqa: PLC0415

    return dist


def _c10d_op(op: types.ReduceOp):
    """The c10d reduce op of ``op``; AVERAGE reduces as SUM (the caller
    divides once)."""
    dist = _dist()
    return {types.ReduceOp.SUM: dist.ReduceOp.SUM,
            types.ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            types.ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
            types.ReduceOp.MIN: dist.ReduceOp.MIN,
            types.ReduceOp.MAX: dist.ReduceOp.MAX}[op]


def _divide(t, n: int):
    """``t / n`` in place (floor division for integer tensors)."""
    if t.is_floating_point():
        return t.div_(n)
    return t.floor_divide_(n)


class TorchDistGroup(BaseGroup):
    """A collective group over one ``torch.distributed`` process group.
    Subclasses set ``self._pg`` (the world's process group) and
    ``self._wire`` (the torch device a tensor is reduced on) and
    implement :meth:`_new_subgroup`."""

    #: Reduce bfloat16 buckets at float32 (the JAX package's gloo group
    #: does, having no numpy bfloat16 to hand to torch).
    _widen_bfloat16 = False

    def __init__(self, world_size: int, rank: int, group_name: str):
        super().__init__(world_size, rank, group_name)
        self._pg = None
        self._wire = None
        # topology.slices -> prebuilt intra-slice / leaders subgroups
        self._hier_cache: dict = {}

    # ---- process-group primitives (in place on ``t``)

    def _all_reduce(self, t, op: types.ReduceOp, pg=None):
        pg = self._pg if pg is None else pg
        dist = _dist()
        opts = dist.AllreduceOptions()
        opts.reduceOp = _c10d_op(op)
        pg.allreduce([t], opts).wait()
        if op == types.ReduceOp.AVERAGE:
            _divide(t, pg.size())
        return t

    def _broadcast(self, t, root: int, pg=None):
        pg = self._pg if pg is None else pg
        dist = _dist()
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        opts.rootTensor = 0
        pg.broadcast([t], opts).wait()
        return t

    def _all_gather(self, t, pg=None) -> list:
        import torch  # noqa: PLC0415

        pg = self._pg if pg is None else pg
        out = [torch.empty_like(t) for _ in range(pg.size())]
        pg.allgather([out], [t]).wait()
        return out

    # ---- staging: caller's tensor <-> a tensor on the wire device

    def _stage(self, tensor):
        """(a contiguous torch tensor on the wire device, the origin):
        a torch tensor already there is used as it is (the verbs are in
        place on it, as the reference's gloo verbs are); anything else
        is copied."""
        import numpy as np  # noqa: PLC0415
        import torch  # noqa: PLC0415

        if isinstance(tensor, torch.Tensor):
            if tensor.device == self._wire and tensor.is_contiguous():
                return tensor, ("torch", tensor)
            return (tensor.detach().to(self._wire).contiguous(),
                    ("torch", tensor))
        arr = np.asarray(tensor)
        return (torch.from_numpy(arr.copy()).to(self._wire),
                (type(tensor).__module__, None))

    @staticmethod
    def _unstage(t, origin, fresh: bool = False):
        """A staged result back to the caller's kind: into the caller's
        own torch tensor where it was copied from one (in place, as
        the reference's gloo verbs are), onto its device for a ``fresh``
        result (a gathered piece), numpy for anything else."""
        module, like = origin
        if module != "torch":
            return t.cpu().numpy()
        if fresh:
            return t.to(like.device)
        if t.data_ptr() != like.data_ptr():
            like.copy_(t)
        return like

    # ---- verbs

    def allreduce(self, tensors, opts: types.AllReduceOptions):
        t, origin = self._stage(tensors[0])
        self._all_reduce(t, opts.reduce_op)
        return [self._unstage(t, origin)]

    def allreduce_coalesced(self, tensors,
                            opts: types.AllReduceCoalescedOptions):
        """Fused path: one flat tensor (and one allreduce) per
        dtype-segregated bucket instead of a per-tensor loop — the
        per-call round trip is paid ~#buckets times, not #tensors
        times.  A reduced-precision bucket (``transport_dtype``) was
        quantized once at pack time; the reduction itself runs at
        float32 (accumulate-in-f32, EQuARX-style).  With
        ``opts.hierarchy`` the reduction runs the two-level intra-slice
        / inter-slice schedule (see :meth:`bucket_reduce`)."""
        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        if getattr(self, "_fusion_stats", None) is None:
            self._fusion_stats = fusion.FusionStats()

        def transfer(flat, bucket):
            return self.bucket_transfer(flat, bucket, opts)

        def reduce_bucket(staged, bucket):
            return self.bucket_reduce(staged, bucket, opts)

        return fusion.run_coalesced(tensors, opts, transfer_fn=transfer,
                                    collective_fn=reduce_bucket,
                                    stats=self._fusion_stats)

    # ---- per-bucket stages (driven by run_coalesced AND GradientSyncer)

    def bucket_transfer(self, flat, bucket,
                        opts: types.AllReduceCoalescedOptions):
        """Move one packed bucket to the wire device (one copy a bucket,
        none when it is already there)."""
        import torch  # noqa: PLC0415

        if bucket.transport_dtype == "int8":
            # pack_bucket produced (codes, scales); ship both as one
            # contiguous byte tensor — THESE are the wire bytes
            # (≈ size + 4·size/QUANT_BLOCK vs 4·size for float32).
            q, scales = flat
            wire = torch.cat([q.view(torch.uint8), scales.view(torch.uint8)])
            return wire.to(self._wire)
        if bucket.transport_dtype != bucket.dtype or (
                self._widen_bfloat16 and bucket.dtype == "bfloat16"):
            # The lossy cast already happened in pack_bucket; upcast so
            # the reduction accumulates at full precision.  Unpack
            # restores the leaf dtype.
            flat = flat.to(torch.float32)
        return flat.to(self._wire)

    def bucket_reduce(self, staged, bucket,
                      opts: types.AllReduceCoalescedOptions):
        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        if getattr(self, "_fusion_stats", None) is None:
            self._fusion_stats = fusion.FusionStats()
        stats = self._fusion_stats
        hier = self._hier_state(opts)
        if bucket.transport_dtype == "int8":
            return self._reduce_bucket_q8(staged, bucket, opts, hier,
                                          stats)
        return self._reduce_bucket_plain(staged, opts, hier, stats)

    # ---- hierarchical (two-level) schedule

    def _new_subgroup(self, ranks: list, tag: str):
        """A process group over ``ranks`` (sorted), or None in a process
        that is not one of them.  Every rank calls it for every subgroup
        in the same order."""
        raise NotImplementedError

    def _hier_state(self, opts) -> dict | None:
        """Prebuilt subgroups for ``opts.hierarchy``, or None when the
        topology degenerates to flat.  Every rank creates every
        subgroup in the same deterministic order; results are cached
        per topology."""
        topo = getattr(opts, "hierarchy", None)
        if (topo is None or self._world_size == 1
                or topo.num_slices <= 1):
            return None
        state = self._hier_cache.get(topo.slices)
        if state is not None:
            return state
        topo.validate(self._world_size)
        my_slice = topo.slice_of(self._rank)
        key = "-".join(",".join(map(str, s)) for s in topo.slices)
        intra_group = None
        for sid, ranks in enumerate(topo.slices):
            group = self._new_subgroup(sorted(ranks), f"{key}/slice{sid}")
            if sid == my_slice:
                intra_group = group
        leaders = sorted(topo.leaders())
        leaders_group = self._new_subgroup(leaders, f"{key}/leaders")
        intra_ranks = tuple(sorted(topo.slices[my_slice]))
        state = {
            "topo": topo,
            "intra": intra_group,
            "intra_ranks": intra_ranks,
            "leaders": leaders_group,
            # The leader is the slice's lowest rank: rank 0 of its
            # subgroup.
            "leader_local": intra_ranks.index(topo.leader(my_slice)),
            "is_leader": self._rank == topo.leader(my_slice),
        }
        self._hier_cache[topo.slices] = state
        return state

    def _reduce_bucket_plain(self, t, opts, hier, stats):
        """Full-precision (or bf16-upcast) bucket reduction.  Flat: one
        world-wide allreduce.  Hierarchical: reduce inside each slice
        (the ICI-analog hop), exchange once per *slice* between slice
        leaders (the DCN hop — num_slices participants, not
        world_size), then fan the result back out within each slice."""
        if hier is None:
            self._all_reduce(t, opts.reduce_op)
            stats.dcn_participants += self._world_size
            return t
        average = opts.reduce_op == types.ReduceOp.AVERAGE
        # AVERAGE averaged per level would double-divide; SUM both
        # levels and divide once at the end.  MIN/MAX/PRODUCT compose
        # level-wise unchanged.
        level_op = types.ReduceOp.SUM if average else opts.reduce_op
        intra_n = len(hier["intra_ranks"])
        if intra_n > 1:
            self._all_reduce(t, level_op, hier["intra"])
        if hier["is_leader"]:
            self._all_reduce(t, level_op, hier["leaders"])
        if intra_n > 1:
            self._broadcast(t, hier["leader_local"], hier["intra"])
        if average:
            t = t / self._world_size
        stats.dcn_participants += hier["topo"].num_slices
        return t

    # ---- int8 blockwise-quantized wire

    @staticmethod
    def _split_q8(wire, size: int):
        """One wire byte tensor → (int8 codes, float32 scales)."""
        import torch  # noqa: PLC0415

        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        n_blocks = fusion.quant_blocks(size)
        codes = wire[:size].view(torch.int8)
        # The scales start at byte ``size``: copied out to an aligned
        # tensor before they are read as float32.
        scales = wire[size:size + 4 * n_blocks].clone().view(torch.float32)
        return codes, scales

    def _gather_dequant_sum(self, wire_t, size: int, group, n: int):
        """all_gather the quantized wire buffers of ``n`` peers (int8
        codes + scales — the only bytes that cross this link), then
        dequantize each contribution and accumulate at float32
        (EQuARX-style: the wire is narrow, the math is not)."""
        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        if n == 1:
            return fusion.dequantize_blockwise(*self._split_q8(wire_t, size))
        acc = None
        for buf in self._all_gather(wire_t, group):
            part = fusion.dequantize_blockwise(*self._split_q8(buf, size))
            acc = part if acc is None else acc + part
        return acc

    def _reduce_bucket_q8(self, wire_t, bucket, opts, hier, stats):
        """Quantized bucket reduction: peers exchange int8 codes +
        scales and every rank accumulates the dequantized contributions
        at float32.  Hierarchical: the intra-slice gather runs within
        the slice, then each slice LEADER re-quantizes its partial sum
        for the once-per-slice DCN exchange and fans the float32 result
        back out."""
        import torch  # noqa: PLC0415

        from ant_ray_tpu_torch.util.collective import fusion  # noqa: PLC0415

        size = bucket.size
        average = opts.reduce_op == types.ReduceOp.AVERAGE
        if hier is None:
            acc = self._gather_dequant_sum(wire_t, size, None,
                                           self._world_size)
            stats.dcn_participants += self._world_size
        else:
            intra_n = len(hier["intra_ranks"])
            acc = self._gather_dequant_sum(wire_t, size, hier["intra"],
                                           intra_n)
            if hier["is_leader"]:
                q2, s2 = fusion.quantize_blockwise(acc)
                wire2 = torch.cat([q2.view(torch.uint8),
                                   s2.view(torch.uint8)])
                acc = self._gather_dequant_sum(
                    wire2, size, hier["leaders"],
                    hier["topo"].num_slices)
            if intra_n > 1:
                acc = self._broadcast(acc.contiguous(), hier["leader_local"],
                                      hier["intra"])
            stats.dcn_participants += hier["topo"].num_slices
        if average:
            acc = acc / self._world_size
        return acc

    def barrier(self, opts: types.BarrierOptions):
        self._pg.barrier(_dist().BarrierOptions()).wait()

    def reduce(self, tensors, opts: types.ReduceOptions):
        dist = _dist()
        t, origin = self._stage(tensors[0])
        ropts = dist.ReduceOptions()
        ropts.reduceOp = _c10d_op(opts.reduce_op)
        ropts.rootRank = opts.root_rank
        ropts.rootTensor = 0
        self._pg.reduce([t], ropts).wait()
        if (opts.reduce_op == types.ReduceOp.AVERAGE
                and self._rank == opts.root_rank):
            _divide(t, self._world_size)
        return [self._unstage(t, origin)]

    def broadcast(self, tensors, opts: types.BroadcastOptions):
        t, origin = self._stage(tensors[0])
        self._broadcast(t, opts.root_rank)
        return [self._unstage(t, origin)]

    def allgather(self, tensors, opts: types.AllGatherOptions):
        t, origin = self._stage(tensors[0])
        return [[self._unstage(o, origin, fresh=True)
                 for o in self._all_gather(t)]]

    def _check_scatter(self, t):
        if t.shape[0] % self._world_size != 0:
            raise ValueError("reducescatter needs dim0 divisible by world")

    def reducescatter(self, tensors, opts: types.ReduceScatterOptions):
        """Allreduce, then this rank's slice of dim 0 (the JAX package's
        gloo group does the same); the NCCL group overrides it with a
        reduce-scatter."""
        t, origin = self._stage(tensors[0])
        self._check_scatter(t)
        self._all_reduce(t, opts.reduce_op)
        chunk = t.shape[0] // self._world_size
        piece = t[self._rank * chunk:(self._rank + 1) * chunk]
        return [self._unstage(piece, origin, fresh=True)]

    def send(self, tensors, opts: types.SendOptions):
        t, _origin = self._stage(tensors[0])
        self._pg.send([t], opts.dst_rank, 0).wait()

    def recv(self, tensors, opts: types.RecvOptions):
        t, origin = self._stage(tensors[0])
        self._pg.recv([t], opts.src_rank, 0).wait()
        return [self._unstage(t, origin)]

