"""DAG layer: build static task/actor graphs with ``.bind()`` and execute
them (ref capability: ray.dag / compiled graphs, SURVEY §2.3 aDAG).

``experimental_compile()`` runs a pipeline of actor methods as per-actor
execution loops over shared-memory channels (``dag.compiled``).
``ant_ray_tpu_torch.dag.collective`` keeps the names of the collective
DAG nodes, which are not ported (ROADMAP queue A item 7)."""

from ant_ray_tpu_torch.dag import collective
from ant_ray_tpu_torch.dag.nodes import (
    ActorMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = ["ActorMethodNode", "DAGNode", "FunctionNode", "InputNode",
           "collective"]
