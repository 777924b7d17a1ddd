"""Logical-axis sharding rules → NamedShardings (counterpart of
ant_ray_tpu/parallel/sharding.py; its rule table copied as data).

Parallelism strategies (DP / FSDP / TP / EP) are a mapping from
*logical* tensor dimensions ("batch", "embed", "heads", …) to mesh axes,
so one model definition serves every strategy by swapping rule tables.
The shardings are parallel/spmd.py's, and placing a tree by them gives
its ShardedTensors.
"""

from __future__ import annotations

from typing import Any, Sequence

from ant_ray_tpu_torch.parallel.spmd import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    _normal,
    device_put,
)

# A rule maps a logical dim name to: None (replicate), one mesh axis, or a
# tuple of mesh axes (dimension sharded over their product).
LogicalAxisRules = dict[str, Any]

# Llama-family rules: batch over (dp, fsdp); sequence over sp; attention
# heads and mlp hidden over tp; params sharded over fsdp on one dim
# (ZeRO-style) and tp on the parallel dim.
DEFAULT_LLAMA_RULES: LogicalAxisRules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": None,
    "embed_param": "fsdp",       # param dim sharded for FSDP/ZeRO
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "experts": "ep",
    "norm": None,
}


def logical_to_spec(logical_dims: Sequence[str | None],
                    rules: LogicalAxisRules | None = None) -> PartitionSpec:
    """("batch","seq","embed") → PartitionSpec(("dp","fsdp"), "sp", None)."""
    rules = rules if rules is not None else DEFAULT_LLAMA_RULES
    parts = []
    for dim in logical_dims:
        if dim is None:
            parts.append(None)
        else:
            if dim not in rules:
                raise KeyError(f"no sharding rule for logical dim {dim!r}")
            parts.append(rules[dim])
    return PartitionSpec(*parts)


def named_sharding(mesh, logical_dims: Sequence[str | None],
                   rules: LogicalAxisRules | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical_dims, rules))


def _dims_of(x, dims):
    return dims if dims is not None else (None,) * len(x.shape)


def shard_pytree(tree, logical_tree, mesh,
                 rules: LogicalAxisRules | None = None):
    """Lay out a (nested dict) tree of tensors by a parallel tree of
    logical dim tuples; logical leaves of None mean replicate."""
    return device_put(tree, pytree_shardings(tree, logical_tree, mesh, rules))


def pytree_shardings(tree, logical_tree, mesh,
                     rules: LogicalAxisRules | None = None):
    """NamedSharding tree parallel to ``tree``."""
    if isinstance(tree, dict):
        return {k: pytree_shardings(v, logical_tree[k], mesh, rules)
                for k, v in tree.items()}
    return named_sharding(mesh, _dims_of(tree, logical_tree), rules)


def constrain(x, logical_dims: Sequence[str | None],
              rules: LogicalAxisRules | None = None):
    """The reference's in-jit sharding constraint, as an assertion: a
    ShardedTensor must already be laid out as ``logical_dims`` say
    (ValueError otherwise), and a plain tensor, which lies on one device,
    is returned as it is.  Nothing here moves data: the port's sharded
    code lays its values out explicitly."""
    if isinstance(x, ShardedTensor):
        want = logical_to_spec(logical_dims, rules)
        if _normal(x.spec) != _normal(want):
            raise ValueError(f"tensor laid out as {x.spec}, constraint "
                             f"wants {want}")
    return x
