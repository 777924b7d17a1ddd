"""DAG layer: build static task/actor graphs with ``.bind()`` and execute
them (ref capability: ray.dag / compiled graphs, SURVEY §2.3 aDAG).

``experimental_compile()`` runs a pipeline of actor methods as per-actor
execution loops over shared-memory channels (``dag.compiled``).
``ant_ray_tpu_torch.dag.collective`` binds collective ops (allreduce /
allgather / reducescatter) as DAG nodes executed by the participating
actors over their collective group."""

from ant_ray_tpu_torch.dag import collective
from ant_ray_tpu_torch.dag.nodes import (
    ActorMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = ["ActorMethodNode", "DAGNode", "FunctionNode", "InputNode",
           "collective"]
