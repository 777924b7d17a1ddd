"""Collective operations as DAG nodes: the names of the JAX package's
``dag/collective.py`` (ref: python/ray/experimental/collective/
operations.py:130-190 and python/ray/dag/collective_node.py —
``allreduce.bind([n1, n2, ...])`` over a collective group of actors).

The port has no collective groups yet, so binding one raises, naming the
ROADMAP item that brings them, as a worker does for the
``__art_collective__`` method."""

from __future__ import annotations


class _CollectiveVerb:
    def __init__(self, verb: str):
        self._verb = verb

    def bind(self, input_nodes, *, group_name: str = "default", op=None):
        raise NotImplementedError(
            f"collective DAG nodes ({self._verb}) are not ported (ROADMAP "
            "queue A item 7)")


#: ``allreduce.bind([...])`` — elementwise reduction across actors.
allreduce = _CollectiveVerb("allreduce")
#: ``allgather.bind([...])`` — every actor receives the concatenation.
allgather = _CollectiveVerb("allgather")
#: ``reducescatter.bind([...])`` — reduce then shard across actors.
reducescatter = _CollectiveVerb("reducescatter")
