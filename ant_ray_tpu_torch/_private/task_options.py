"""Per-task / per-actor submission options (ref: @ray.remote(**opts) surface,
python/ray/_private/ray_option_utils.py)."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TaskOptions:
    num_cpus: float | None = None
    num_tpus: float | None = None          # TPU chips (ref uses resources={"TPU": n})
    num_gpus: float | None = None          # accepted for API parity; maps to resources
    resources: dict[str, float] = dataclasses.field(default_factory=dict)
    num_returns: int = 1
    max_retries: int | None = None
    retry_exceptions: bool = False
    name: str = ""
    runtime_env: dict | None = None
    scheduling_strategy: Any = None        # "DEFAULT" | "SPREAD" | PG strategy
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    # Node-label constraint, e.g. {"gpu-pod-name": "slice-A"}
    # (ref: @ray.remote(label_selector=...))
    label_selector: dict | None = None
    # Actor-method routing to a named executor pool (actor tasks only;
    # ref: @ray.method(concurrency_group=...))
    concurrency_group: str = ""
    _metadata: dict = dataclasses.field(default_factory=dict)

    def resource_demand(self, default_num_cpus: float = 1.0) -> dict[str, float]:
        demand = dict(self.resources)
        cpus = self.num_cpus if self.num_cpus is not None else default_num_cpus
        if cpus:
            demand["CPU"] = demand.get("CPU", 0.0) + cpus
        if self.num_tpus:
            demand["TPU"] = demand.get("TPU", 0.0) + self.num_tpus
        if self.num_gpus:
            demand["GPU"] = demand.get("GPU", 0.0) + self.num_gpus
        return demand

    def merged_with(self, **overrides) -> "TaskOptions":
        new = dataclasses.replace(self)
        for key, value in overrides.items():
            if value is None and key != "scheduling_strategy":
                continue
            if not hasattr(new, key):
                raise ValueError(f"Unknown option {key!r}")
            setattr(new, key, value)
        return new


@dataclasses.dataclass
class ActorOptions(TaskOptions):
    max_restarts: int | None = None
    max_task_retries: int = 0
    max_concurrency: int = 1
    # Named bounded thread pools, e.g. {"io": 2, "compute": 4} (ref:
    # @ray.remote(concurrency_groups=...), concurrency_group_manager.h)
    concurrency_groups: dict[str, int] | None = None
    max_pending_calls: int = -1
    lifetime: str | None = None            # None | "detached"
    namespace: str | None = None
    get_if_exists: bool = False

    def resource_demand(self, default_num_cpus: float = 0.0) -> dict[str, float]:
        """Resources held while the actor is alive.  Default 0 CPU (ref
        semantics: running actors hold no CPU), so long-lived actors don't
        starve task scheduling; explicit num_cpus/num_tpus are held."""
        return super().resource_demand(default_num_cpus)

    def placement_demand(self) -> dict[str, float]:
        """Resources the scheduler matches when *placing* the actor —
        default 1 CPU (ref semantics: placement uses 1 CPU, running uses
        0), which bounds how many default actors pack onto a node."""
        return super().resource_demand(1.0)
