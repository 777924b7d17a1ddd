"""DAG nodes: lazily-bound task/actor-method call graphs.

Mirror of the reference's DAG surface (ref: python/ray/dag/dag_node.py +
compiled_dag_node.py:805): ``fn.bind(x)`` / ``actor.method.bind(x)``
build nodes, ``InputNode`` marks runtime inputs, ``node.execute(*args)``
submits the whole graph (dependencies flow as ObjectRefs, so independent
branches run in parallel and data moves through the object plane without
driver round-trips).  ``experimental_compile`` turns a pipeline of actor
methods into per-actor execution loops over shared-memory channels
(``dag/compiled.py``); any other graph gets the interpreted executor,
which pre-resolves the topology.
"""

from __future__ import annotations

from typing import Any


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ---- traversal

    def _children(self):
        for value in list(self._bound_args) + list(
                self._bound_kwargs.values()):
            if isinstance(value, DAGNode):
                yield value

    def _topology(self) -> list["DAGNode"]:
        order: list[DAGNode] = []
        seen: set[int] = set()
        on_stack: set[int] = set()

        def visit(node: DAGNode):
            nid = id(node)
            if nid in on_stack:
                raise ValueError("cycle detected in DAG")
            if nid in seen:
                return
            on_stack.add(nid)
            for child in node._children():
                visit(child)
            on_stack.discard(nid)
            seen.add(nid)
            order.append(node)

        visit(self)
        return order

    # ---- execution

    def execute(self, *input_args, **input_kwargs):
        """Submit the graph; returns the ObjectRef of this (output) node."""
        return _run(self._topology(), self, input_args, input_kwargs)

    def experimental_compile(self, buffer_size_bytes: int = 8 << 20,
                             overlap: bool = True,
                             _force_interpreted: bool = False):
        """Compile to channel-connected per-actor exec loops
        (``dag/compiled.py``).  ``overlap`` enables the per-actor
        read/compute overlap pass (ref: dag_node_operation.py op
        reordering).  Graphs that aren't pure actor-method pipelines —
        or hosts without the native channel extension — fall back to
        the interpreted pre-resolved executor."""
        if not _force_interpreted:
            from ant_ray_tpu_torch._private.native import load_native  # noqa: PLC0415
            from ant_ray_tpu_torch.dag.compiled import ChannelCompiledDAG  # noqa: PLC0415

            if load_native() is not None:
                try:
                    return ChannelCompiledDAG(self, buffer_size_bytes,
                                              overlap=overlap)
                except ValueError:
                    pass  # not an actor-only graph
        return CompiledDAG(self)

    def _resolve_bound(self, resolved):
        def value(v):
            return resolved[id(v)] if isinstance(v, DAGNode) else v

        return (tuple(value(a) for a in self._bound_args),
                {k: value(v) for k, v in self._bound_kwargs.items()})

    def _submit(self, resolved, input_args, input_kwargs):
        raise NotImplementedError


def _run(order, output, input_args, input_kwargs):
    resolved: dict[int, Any] = {}
    for node in order:
        resolved[id(node)] = node._submit(resolved, input_args,
                                          input_kwargs)
    return resolved[id(output)]


class InputNode(DAGNode):
    """Placeholder for a runtime input (ref: ray.dag.InputNode).

    Supports ``with InputNode() as inp:`` for API parity."""

    def __init__(self, index: int = 0):
        super().__init__((), {})
        self._index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _submit(self, resolved, input_args, input_kwargs):
        if self._index >= len(input_args):
            raise ValueError(
                f"DAG executed with {len(input_args)} inputs but input "
                f"#{self._index} is bound")
        return input_args[self._index]


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_function = remote_function

    def _submit(self, resolved, input_args, input_kwargs):
        args, kwargs = self._resolve_bound(resolved)
        return self._remote_function.remote(*args, **kwargs)


class ActorMethodNode(DAGNode):
    def __init__(self, handle, method_name: str, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._handle = handle
        self._method_name = method_name

    def _submit(self, resolved, input_args, input_kwargs):
        args, kwargs = self._resolve_bound(resolved)
        method = getattr(self._handle, self._method_name)
        return method.remote(*args, **kwargs)


class CompiledDAG:
    """Pre-resolved topology executor (ref: CompiledDAG.execute)."""

    def __init__(self, output: DAGNode):
        self._output = output
        self._order = output._topology()

    def execute(self, *input_args, **input_kwargs):
        return _run(self._order, self._output, input_args, input_kwargs)

    def teardown(self):
        pass
