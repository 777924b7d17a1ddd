"""GPU slice reservation — topology-aware gang scheduling.

The counterpart of the JAX package's ``util/tpu.py``, with a GPU slice
in place of a TPU slice (``accelerators/gpu.py`` says what a slice is on
NVIDIA: the hosts of one NVLink domain, or one host of its own).  The
GCS placement planner supports a *same-label* constraint — one placement
group whose bundles must all land on nodes sharing a ``gpu-pod-name`` —
so a whole multi-host slice is reserved atomically with the existing
2-phase bundle commit.

Rank→host mapping is deterministic: bundle ``i`` carries the label
selector ``{"gpu-worker-id": str(i)}``, so worker ``i`` of the training
job sits on host ``i`` of the slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from ant_ray_tpu_torch._private.accelerators import gpu as gpu_accel
from ant_ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)


@dataclass(frozen=True)
class SlicePlacementGroup:
    """A reserved (or reserving) whole GPU slice.

    ``placement_group`` holds one bundle per host; task/actor
    ``options(placement_group=..., placement_group_bundle_index=rank)``
    pins each rank to its host.
    """

    placement_group: PlacementGroup
    topology: str
    generation: str
    num_hosts: int
    chips_per_host: int

    @property
    def pod_type(self) -> str:
        return gpu_accel.infer_pod_type(self.topology, self.generation)

    @property
    def num_chips(self) -> int:
        return gpu_accel.topology_chip_count(self.topology)

    def ready(self, timeout: float = 100.0) -> bool:
        return self.placement_group.ready(timeout=timeout)

    def remove(self) -> None:
        remove_placement_group(self.placement_group)


def _slice_bundles(num_hosts: int, chips: int, pod_type: str,
                   generation: str, bundle_extra: dict | None
                   ) -> tuple[list[dict], list[dict]]:
    """One slice's bundles and label selectors: host i on
    ``gpu-worker-id == i``; bundle 0 also reserves the slice's head."""
    bundles: list[dict] = []
    selectors: list[dict] = []
    for host in range(num_hosts):
        # bundle_extra: per-host resources the gang's actors will demand
        # beyond cards (typically {"CPU": 1}) — reserved here so the
        # bundle can actually host them.
        bundle = {"GPU": float(chips), **(bundle_extra or {})}
        if host == 0:
            bundle[f"GPU-{pod_type}-head"] = 1.0
        bundles.append(bundle)
        selectors.append({"gpu-worker-id": str(host),
                          "gpu-generation": generation})
    return bundles, selectors


def slice_placement_group(topology: str,
                          accelerator_type: str = "H100",
                          name: str = "",
                          bundle_extra: dict | None = None
                          ) -> SlicePlacementGroup:
    """Reserve one whole GPU slice of ``topology`` (e.g. "2x8").

    Every bundle lands on a node advertising the same ``gpu-pod-name``
    (one physical slice), bundle i on the host with
    ``gpu-worker-id == i``; bundle 0 additionally reserves the
    ``GPU-<pod_type>-head`` resource so at most one job owns a slice.
    """
    generation = gpu_accel.normalize_generation(accelerator_type)
    num_hosts = gpu_accel.hosts_in_slice(topology, generation)
    chips = gpu_accel.chips_per_host(topology, generation)
    pod_type = gpu_accel.infer_pod_type(topology, generation)
    bundles, selectors = _slice_bundles(num_hosts, chips, pod_type,
                                        generation, bundle_extra)
    pg = placement_group(
        bundles,
        strategy="STRICT_SPREAD" if num_hosts > 1 else "STRICT_PACK",
        name=name or f"slice-{pod_type}",
        bundle_label_selectors=selectors,
        _same_label="gpu-pod-name" if num_hosts > 1 else None,
    )
    return SlicePlacementGroup(
        placement_group=pg, topology=topology, generation=generation,
        num_hosts=num_hosts, chips_per_host=chips)


@dataclass(frozen=True)
class MultiSlicePlacementGroup:
    """A reserved gang spanning ``num_slices`` whole GPU slices.

    ONE placement group holds ``num_slices * hosts_per_slice`` bundles
    in contiguous per-slice blocks: bundle ``s * hosts_per_slice + i``
    is host ``i`` of slice ``s``.  The GCS planner's same-label-groups
    constraint pins each block to one ``gpu-pod-name`` and distinct
    blocks to distinct pods, so the whole multi-slice reservation
    commits (or rolls back) atomically.  The matching rank→slice
    partition for the hierarchical allreduce is
    ``SliceTopology.regular(num_hosts, num_slices)``.
    """

    placement_group: PlacementGroup
    topology: str
    generation: str
    num_slices: int
    hosts_per_slice: int
    chips_per_host: int

    @property
    def num_hosts(self) -> int:
        return self.num_slices * self.hosts_per_slice

    @property
    def pod_type(self) -> str:
        return gpu_accel.infer_pod_type(self.topology, self.generation)

    def slice_of_bundle(self, index: int) -> int:
        return index // self.hosts_per_slice

    def ready(self, timeout: float = 100.0) -> bool:
        return self.placement_group.ready(timeout=timeout)

    def remove(self) -> None:
        remove_placement_group(self.placement_group)


def multi_slice_placement_group(topology: str,
                                num_slices: int,
                                accelerator_type: str = "H100",
                                name: str = "",
                                bundle_extra: dict | None = None
                                ) -> MultiSlicePlacementGroup:
    """Reserve ``num_slices`` whole GPU slices of ``topology`` each —
    the multi-slice (data-parallel across NVLink domains) gang
    reservation.

    Per slice s: bundle ``s * num_hosts + i`` lands on the host with
    ``gpu-worker-id == i`` of one physical slice (all of slice s's
    bundles share a ``gpu-pod-name``; distinct s get distinct pods),
    and bundle ``s * num_hosts`` additionally reserves that pod's
    ``GPU-<pod_type>-head`` resource so no other job grabs the slice.
    """
    if num_slices <= 0:
        raise ValueError(f"num_slices must be positive, got {num_slices}")
    generation = gpu_accel.normalize_generation(accelerator_type)
    num_hosts = gpu_accel.hosts_in_slice(topology, generation)
    chips = gpu_accel.chips_per_host(topology, generation)
    pod_type = gpu_accel.infer_pod_type(topology, generation)

    bundles: list[dict] = []
    selectors: list[dict] = []
    groups: list[list[int]] = []
    for s in range(num_slices):
        groups.append(list(range(s * num_hosts, (s + 1) * num_hosts)))
        b, sel = _slice_bundles(num_hosts, chips, pod_type, generation,
                                bundle_extra)
        bundles += b
        selectors += sel

    pg = placement_group(
        bundles,
        strategy="STRICT_SPREAD" if num_hosts > 1 else "PACK",
        name=name or f"multislice-{pod_type}x{num_slices}",
        bundle_label_selectors=selectors,
        _same_label="gpu-pod-name",
        _same_label_groups=groups,
    )
    return MultiSlicePlacementGroup(
        placement_group=pg, topology=topology, generation=generation,
        num_slices=num_slices, hosts_per_slice=num_hosts,
        chips_per_host=chips)
