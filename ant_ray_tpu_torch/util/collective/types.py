"""Collective types (ref: python/ray/util/collective/types.py — Backend :34,
ReduceOp :55): a copy of the JAX package's ``util/collective/types.py``,
whose ``xla`` backend (XLA collectives over ICI/DCN) becomes ``nccl``
(NCCL over NVLink/PCIe, and the network across hosts) beside ``gloo``.

``SliceTopology`` keeps its name and meaning: a partition of a group's
ranks into blocks that share a fast link, for the two-level allreduce.
On a GPU host a block is the ranks of one node (NVLink), and the level
between blocks is the network; the docstrings keep the reference's
ICI/DCN names for the two levels."""

from __future__ import annotations

import enum
from dataclasses import dataclass


@dataclass(frozen=True)
class SliceTopology:
    """Partition of a collective group's ranks into accelerator slices.

    Ranks inside one slice share fast interconnect (ICI); distinct
    slices talk over the datacenter network (DCN).  The hierarchical
    allreduce reduces within each slice first, exchanges once per
    *slice* across DCN, then fans back out — so the cross-slice
    message count scales with ``num_slices``, not world size.

    Hashable (tuples all the way down) so it can key compile caches.

    ``ici_bucket_bytes`` / ``dcn_bucket_bytes`` optionally override the
    fusion bucket budget per level: the intra-slice (ICI) hop is
    launch-bound, so smaller buckets pipeline better there, while the
    latency-dominated cross-slice (DCN) hop amortizes its round trips
    over larger buckets.  ``None`` inherits the caller's flat
    ``bucket_bytes``.
    """

    slices: tuple                        # tuple[tuple[int, ...], ...]
    ici_bucket_bytes: "int | None" = None
    dcn_bucket_bytes: "int | None" = None

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @staticmethod
    def regular(world_size: int, num_slices: int) -> "SliceTopology":
        """Contiguous equal partition: rank r sits in slice
        r // (world_size // num_slices)."""
        if num_slices <= 0 or world_size % num_slices != 0:
            raise ValueError(
                f"world_size {world_size} not divisible into "
                f"{num_slices} slices")
        per = world_size // num_slices
        return SliceTopology(tuple(
            tuple(range(s * per, (s + 1) * per))
            for s in range(num_slices)))

    @staticmethod
    def from_labels(pod_names) -> "SliceTopology":
        """Derive membership from each rank's ``gpu-pod-name`` node
        label (accelerators/gpu.py topology metadata): ranks on the
        same physical slice share a pod name, and a rank without one
        (``None``/"") is a slice of its own."""
        from ant_ray_tpu_torch._private.accelerators import gpu as gpu_accel  # noqa: PLC0415

        return SliceTopology(tuple(gpu_accel.slice_groups(pod_names)))

    def validate(self, world_size: int) -> None:
        flat = sorted(r for ranks in self.slices for r in ranks)
        if flat != list(range(world_size)):
            raise ValueError(
                f"slice topology {self.slices} is not a partition of "
                f"ranks 0..{world_size - 1}")

    def slice_of(self, rank: int) -> int:
        for sid, ranks in enumerate(self.slices):
            if rank in ranks:
                return sid
        raise ValueError(f"rank {rank} is in no slice")

    def peers(self, rank: int) -> tuple:
        return self.slices[self.slice_of(rank)]

    def leader(self, slice_id: int) -> int:
        """The slice's DCN representative (lowest rank)."""
        return min(self.slices[slice_id])

    def leaders(self) -> tuple:
        return tuple(self.leader(s) for s in range(self.num_slices))

    def per_level_bucket_bytes(self, default: int) -> tuple:
        """(ici, dcn) bucket budgets with ``default`` filling unset
        levels — the pair the fusion planner consumes."""
        return (self.ici_bucket_bytes or int(default),
                self.dcn_bucket_bytes or int(default))

    def with_bucket_bytes(self, ici: "int | None" = None,
                          dcn: "int | None" = None) -> "SliceTopology":
        """Copy with per-level fusion budgets attached (frozen
        dataclass — returns a new topology)."""
        from dataclasses import replace  # noqa: PLC0415

        return replace(self, ici_bucket_bytes=ici, dcn_bucket_bytes=dcn)


class Backend:
    """Supported backends: ``nccl`` (NCCL collectives on CUDA tensors,
    aliases ``cuda`` and ``gpu`` — the counterpart of the reference's
    ``xla``) and ``gloo`` (over sockets, aliases ``cpu`` and
    ``torch_gloo``).  ``xla`` and its aliases are refused, as the
    reference refuses ``nccl``."""

    NCCL = "nccl"
    GLOO = "gloo"

    @staticmethod
    def normalize(name: str) -> str:
        name = name.lower()
        if name in ("nccl", "cuda", "gpu"):
            return Backend.NCCL
        if name in ("gloo", "cpu", "torch_gloo"):
            return Backend.GLOO
        if name in ("xla", "tpu", "ici"):
            raise ValueError(
                "XLA collectives are not available in the PyTorch/CUDA "
                "build; use backend='nccl' (NCCL on CUDA tensors) "
                "instead")
        raise ValueError(f"Unknown collective backend {name!r}")


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    AVERAGE = "average"


@dataclass
class AllReduceOptions:
    reduce_op: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30_000


@dataclass
class AllReduceCoalescedOptions:
    """Knobs of the fused bucketed allreduce (util/collective/fusion.py).

    ``bucket_bytes`` — flat-buffer budget per collective (a leaf larger
    than it gets its own oversized bucket).  ``transport_dtype`` —
    opt-in reduced-precision wire format for wide float buckets:
    ``"bfloat16"`` halves wire width, ``"int8"`` ships blockwise-scaled
    int8 codes plus a float32 scale sidecar (~0.25x the float32 wire
    bytes; SUM/AVERAGE only — other ops fall back to unquantized).
    Accumulation stays float32 either way (EQuARX-style).
    ``overlap`` — pipeline bucket k+1's pack+transfer with bucket k's
    collective (False = sequential naive-order baseline).
    ``hierarchy`` — a :class:`SliceTopology` switching the reduction to
    the two-level intra-slice (ICI) / inter-slice (DCN) schedule."""

    reduce_op: ReduceOp = ReduceOp.SUM
    bucket_bytes: int = 4 << 20
    transport_dtype: "str | None" = None
    overlap: bool = True
    hierarchy: "SliceTopology | None" = None
    timeout_ms: int = 30_000


@dataclass
class BarrierOptions:
    timeout_ms: int = 30_000


@dataclass
class ReduceOptions:
    reduce_op: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = 30_000


@dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = 30_000


@dataclass
class AllGatherOptions:
    timeout_ms: int = 30_000


@dataclass
class ReduceScatterOptions:
    reduce_op: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30_000


@dataclass
class SendOptions:
    dst_rank: int = 0
    timeout_ms: int = 30_000


@dataclass
class RecvOptions:
    src_rank: int = 0
    timeout_ms: int = 30_000
