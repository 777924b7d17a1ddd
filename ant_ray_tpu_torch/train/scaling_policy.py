"""Worker-group scaling policies
(ref: train/v2/_internal/execution/scaling_policy/ — the controller
asks the policy how large the next worker group should be at every
(re)start; FixedScalingPolicy demands the configured size, the elastic
policy fits the group to what the cluster can actually place).

A copy of the JAX package's ``train/scaling_policy.py``.  Resize points
match the reference: group start and group restart after a failure.
A mid-run resize is a group restart — training resumes from
the latest checkpoint, which is exactly the failure-recovery path, so
elasticity reuses it rather than inventing a second lifecycle.
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger(__name__)


class ScalingPolicy:
    """Decides the world size for the next worker-group launch."""

    def workers_for_attempt(self, scaling, available: dict,
                            total: dict, attempt: int = 0) -> int:
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size (ref: FixedScalingPolicy)."""

    def workers_for_attempt(self, scaling, available, total,
                            attempt: int = 0) -> int:
        return scaling.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    """Fit the group to current capacity within [min_workers,
    num_workers] (ref: the elastic scaling decision — size the next
    group by how many rank bundles the cluster can place now).

    A shrunken cluster yields a smaller world; when capacity returns,
    the next (re)start grows back toward num_workers.
    """

    def __init__(self, min_workers: int):
        if min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        self.min_workers = min_workers
        # Upper bound learned from reservation failures: aggregate
        # capacity can over-estimate what is PLACEABLE (per-node
        # fragmentation), so an unplaceable gang steps the next request
        # down instead of burning every attempt at the same size.
        self._cap: int | None = None

    def _placeable(self, scaling, resources: dict) -> int:
        demand = scaling.worker_resources()
        counts = []
        for key, per_worker in demand.items():
            if per_worker <= 0:
                continue
            counts.append(int(resources.get(key, 0.0) // per_worker))
        return min(counts) if counts else scaling.num_workers

    def workers_for_attempt(self, scaling, available, total,
                            attempt: int = 0) -> int:
        # First attempt sizes by TOTAL capacity (the group's own PG
        # frees its bundles between attempts; transient consumers
        # shouldn't shrink the world permanently).  Retries also
        # consult the AVAILABLE view: if reservations keep failing, a
        # co-tenant is holding capacity for real, and re-requesting the
        # total-derived size would burn every failure attempt on an
        # unplaceable gang.
        fit = self._placeable(scaling, total)
        if attempt > 0:
            avail_fit = self._placeable(scaling, available)
            fit = min(fit, max(self.min_workers, avail_fit))
        if self._cap is not None:
            fit = min(fit, self._cap)
        world = max(self.min_workers, min(scaling.num_workers, fit))
        if world < scaling.num_workers:
            logger.warning(
                "elastic: cluster fits %d/%d workers — launching a "
                "reduced group", world, scaling.num_workers)
        return world

    def note_unplaceable(self, world: int) -> None:
        """A gang of ``world`` bundles timed out: step down next time."""
        self._cap = max(self.min_workers, world - 1)

    def note_group_started(self) -> None:
        """A group launched: forget the learned cap (capacity may have
        returned; the next restart probes upward again)."""
        self._cap = None


def policy_for(scaling) -> ScalingPolicy:
    if getattr(scaling, "min_workers", 0):
        if scaling.use_gpu and scaling.topology:
            raise ValueError(
                "elastic scaling (min_workers) cannot be combined with a "
                "whole-slice topology reservation — a slice's NVLink "
                "domain has a fixed host count")
        return ElasticScalingPolicy(scaling.min_workers)
    return FixedScalingPolicy()
