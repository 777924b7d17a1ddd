"""Placement groups: atomic gang reservation of resource bundles
(ref: src/ray/gcs/gcs_placement_group_manager.h:55, bundle policies
src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h:81-105,
python/ray/util/placement_group.py API).

Strategies: PACK (prefer one node), SPREAD (prefer distinct nodes),
STRICT_PACK (must be one node), STRICT_SPREAD (must be distinct nodes).
Reservation is two-phase (prepare on every node, then commit; any prepare
failure rolls back) so concurrent groups can't deadlock on partial
reservations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ant_ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass(frozen=True)
class PlacementGroup:
    id: PlacementGroupID
    bundles: tuple
    strategy: str

    def ready(self, timeout: float = 30.0) -> bool:
        """Block until the group is reserved (ref: pg.ready())."""
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        runtime = global_worker.runtime
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            state = runtime._gcs.call(
                "GetPlacementGroup", {"pg_id": self.id}, retries=3)
            if state is None:
                raise ValueError("placement group was removed")
            if state["state"] == "CREATED":
                return True
            if state["state"] == "FAILED":
                raise RuntimeError(
                    f"placement group infeasible: {state.get('reason', '')}")
            time.sleep(0.05)
        return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def bundle_node(self, index: int):
        """Node address hosting a bundle (for debugging/tests)."""
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        state = global_worker.runtime._gcs.call(
            "GetPlacementGroup", {"pg_id": self.id}, retries=3)
        return state["bundle_nodes"][index] if state else None


def placement_group(bundles: list[dict], strategy: str = "PACK",
                    name: str = "",
                    bundle_label_selectors: list[dict] | None = None,
                    _same_label: str | None = None,
                    _same_label_groups: "list | None" = None
                    ) -> PlacementGroup:
    """``bundle_label_selectors``: optional per-bundle node-label
    constraints (ref: bundle_label_selector in reserve_tpu_slice,
    python/ray/_private/accelerators/tpu.py:213).  ``_same_label``: a
    label key whose value must be shared by every bundle's node — the
    slice-affinity primitive behind ``util/gpu.py``'s
    slice_placement_group().  ``_same_label_groups``: lists of bundle indices;
    each group's nodes share one ``_same_label`` value and distinct
    groups get DISTINCT values — the multi-slice primitive (one group
    per physical slice) behind its multi_slice_placement_group()."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    if bundle_label_selectors is not None and \
            len(bundle_label_selectors) != len(bundles):
        raise ValueError("bundle_label_selectors must match bundles 1:1")
    global_worker._check_connected()
    runtime = global_worker.runtime
    pg_id = PlacementGroupID.of(runtime.job_id)
    runtime._gcs.call("CreatePlacementGroup", {
        "pg_id": pg_id,
        "bundles": [dict(b) for b in bundles],
        "strategy": strategy,
        "name": name,
        "job_id": runtime.job_id,  # VC-aware bundle placement
        "bundle_label_selectors": bundle_label_selectors,
        "same_label": _same_label,
        "same_label_groups": ([list(g) for g in _same_label_groups]
                              if _same_label_groups else None),
    }, retries=3)
    return PlacementGroup(pg_id, tuple(tuple(sorted(b.items()))
                                       for b in bundles), strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker.runtime._gcs.call(
        "RemovePlacementGroup", {"pg_id": pg.id}, retries=3)


def placement_group_table() -> dict:
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    return global_worker.runtime._gcs.call(
        "ListPlacementGroups", retries=3)
