"""Scheduling strategies (capability mirror of
ray.util.scheduling_strategies + the raylet's scheduling policy set,
ref: src/ray/raylet/scheduling/policy/composite_scheduling_policy.h:33 —
hybrid pack/spread default, SPREAD, node affinity):

* ``"DEFAULT"`` / ``None`` — hybrid: pack onto busier feasible nodes
  until they pass the utilization threshold, then spread to the
  least-loaded (ref: hybrid_scheduling_policy.h).
* ``"SPREAD"`` — round-robin across feasible nodes (ref:
  spread_scheduling_policy.h).
* :class:`NodeAffinitySchedulingStrategy` — pin to one node; ``soft``
  falls back to DEFAULT when the node is gone (ref:
  node_affinity_scheduling_policy.h).

Pass via ``@art.remote(scheduling_strategy=...)`` or
``.options(scheduling_strategy=...)`` on tasks and actors.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NodeAffinitySchedulingStrategy:
    """Run on the node with this id (hex string, from ``art.nodes()``
    or ``ART_NODE_ID`` inside a worker)."""

    node_id: str
    soft: bool = False

    def wire(self) -> dict:
        return {"kind": "node_affinity", "node_id": self.node_id,
                "soft": self.soft}


def strategy_wire(strategy) -> dict | str | None:
    """Normalize a user strategy to its picklable wire form."""
    if strategy is None or strategy == "DEFAULT":
        return None
    if strategy == "SPREAD":
        return "SPREAD"
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return strategy.wire()
    raise ValueError(
        f"unknown scheduling_strategy {strategy!r}; expected 'DEFAULT', "
        "'SPREAD', or NodeAffinitySchedulingStrategy")
