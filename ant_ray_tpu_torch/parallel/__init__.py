"""Parallelism layer: device meshes, sharding plans, sequence-parallel
attention (ring / Ulysses) and the GPipe schedule (counterpart of
ant_ray_tpu/parallel/).  The cells of a mesh run in one process:
parallel/spmd.py holds the sharded tensors and the collectives that
XLA's partitioner and ``shard_map`` provide to the JAX package."""

from ant_ray_tpu_torch.parallel.mesh import (
    AxisNames,
    Mesh,
    MeshConfig,
    build_mesh,
    local_chip_mesh,
    local_device_mesh,
)
from ant_ray_tpu_torch.parallel.sharding import (
    DEFAULT_LLAMA_RULES,
    LogicalAxisRules,
    constrain,
    logical_to_spec,
    named_sharding,
    pytree_shardings,
    shard_pytree,
)
from ant_ray_tpu_torch.parallel.spmd import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    device_put,
)
from ant_ray_tpu_torch.parallel.ring import ring_attention
from ant_ray_tpu_torch.parallel.ulysses import ulysses_attention
from ant_ray_tpu_torch.parallel.pipeline import gpipe

__all__ = [
    "AxisNames",
    "DEFAULT_LLAMA_RULES",
    "LogicalAxisRules",
    "Mesh",
    "MeshConfig",
    "NamedSharding",
    "PartitionSpec",
    "ShardedTensor",
    "build_mesh",
    "constrain",
    "device_put",
    "gpipe",
    "local_chip_mesh",
    "local_device_mesh",
    "logical_to_spec",
    "named_sharding",
    "pytree_shardings",
    "ring_attention",
    "shard_pytree",
    "ulysses_attention",
]
