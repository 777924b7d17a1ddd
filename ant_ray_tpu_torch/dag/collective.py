"""Collective operations as DAG nodes
(ref: python/ray/experimental/collective/operations.py:130-190 and
python/ray/dag/collective_node.py — ``allreduce.bind([n1, n2, ...])``
turns per-actor tensors into their elementwise reduction, executed BY
the actors over their collective group).

Semantics mirrored from the reference:

* inputs must be bound actor-method nodes on DISTINCT actors that
  already form a collective group (``create_collective_group``);
* ``bind`` returns one output node per input actor;
* executing ANY of the outputs triggers the whole group — a collective
  is all-or-nothing, so the group submits together (the reference
  schedules all peers' ops in the compiled schedule; here the shared
  ``_GroupBind`` submits every peer's op the first time any peer
  resolves, which keeps a single ``.execute()`` from deadlocking the
  rendezvous).

The op itself runs inside each actor's worker process via the
``__art_collective__`` execution hook, against the group state the
actor created with ``init_collective_group`` — NCCL on GPU actors, gloo
on CPU actors.  A copy of the JAX package's ``dag/collective.py``.
"""

from __future__ import annotations

from typing import Any

from ant_ray_tpu_torch.dag.nodes import ActorMethodNode, DAGNode
from ant_ray_tpu_torch.util.collective.types import ReduceOp


class CollectiveOutputNode(DAGNode):
    """The post-collective tensor on one participating actor."""

    def __init__(self, group_bind: "_GroupBind", index: int):
        super().__init__((), {})
        self._group_bind = group_bind
        self._index = index

    def _children(self):
        # Every peer's input is a dependency of every output: the graph
        # must pull ALL inputs in before any actor enters the collective
        # (a missing peer would hang the rendezvous forever).
        yield from self._group_bind.inputs

    def _submit(self, resolved: dict, input_args, input_kwargs):
        return self._group_bind.submit_all(resolved)[self._index]


class _GroupBind:
    """Shared state of one bound collective: inputs, verb, group."""

    def __init__(self, verb: str, inputs: list[ActorMethodNode],
                 group_name: str, op: ReduceOp):
        self.verb = verb
        self.inputs = list(inputs)
        self.group_name = group_name
        self.op = op
        handles = []
        for node in self.inputs:
            handle = getattr(node, "_handle", None)
            if handle is None:
                raise ValueError(
                    "collective inputs must be bound actor-method nodes "
                    f"(got {type(node).__name__})")
            handles.append(handle)
        if len({h.actor_id for h in handles}) != len(handles):
            raise ValueError(
                "collective inputs must live on distinct actors — the "
                "same actor cannot hold two ranks of one group")
        self.handles = handles

    def submit_all(self, resolved: dict) -> list:
        """Submit every peer's collective task once PER EXECUTION; the
        cache lives in the execution's ``resolved`` map (keyed by this
        bind), so re-executing the DAG re-runs the collective against
        the fresh input refs instead of returning stale results."""
        cached = resolved.get(id(self))
        if cached is not None:
            return cached
        from ant_ray_tpu_torch._private.task_options import TaskOptions  # noqa: PLC0415
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        refs = []
        world = len(self.handles)
        for handle, node in zip(self.handles, self.inputs):
            tensor_ref = resolved[id(node)]
            refs.append(global_worker.submit_actor_task(
                handle, "__art_collective__",
                (self.verb, self.group_name, self.op.name, tensor_ref,
                 world),
                {}, TaskOptions()))
        resolved[id(self)] = refs
        return refs


class _CollectiveVerb:
    def __init__(self, verb: str):
        self._verb = verb

    def bind(self, input_nodes: list[ActorMethodNode], *,
             group_name: str = "default",
             op: ReduceOp = ReduceOp.SUM) -> list[CollectiveOutputNode]:
        if not input_nodes:
            raise ValueError("collective bind needs at least one input")
        group = _GroupBind(self._verb, input_nodes, group_name, op)
        return [CollectiveOutputNode(group, i)
                for i in range(len(input_nodes))]


#: ``allreduce.bind([...])`` — elementwise reduction across actors.
allreduce = _CollectiveVerb("allreduce")
#: ``allgather.bind([...])`` — every actor receives the concatenation.
allgather = _CollectiveVerb("allgather")
#: ``reducescatter.bind([...])`` — reduce then shard across actors.
reducescatter = _CollectiveVerb("reducescatter")


def execute_op(verb: str, group_name: str, op_name: str, tensor,
               bind_world: int | None = None) -> Any:
    """Worker-side execution hook (dispatched by the task executor for
    ``__art_collective__`` method calls)."""
    from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415

    if bind_world is not None:
        actual = col.get_collective_group_size(group_name)
        if actual != bind_world:
            # Loud error beats the guaranteed rendezvous deadlock a
            # partial bind would otherwise hang in.
            raise ValueError(
                f"collective bound over {bind_world} actor(s) but group "
                f"{group_name!r} has world size {actual} — bind must "
                "cover every rank of the group")
    op = ReduceOp[op_name]
    if verb == "allreduce":
        return col.allreduce(tensor, group_name, op)
    if verb == "allgather":
        return col.allgather(tensor, group_name)
    if verb == "reducescatter":
        return col.reducescatter(tensor, group_name, op)
    raise ValueError(f"unknown collective verb {verb!r}")
