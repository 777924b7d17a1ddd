"""Sharded tensors and the collectives between mesh cells, in one
process (port-only: the counterpart of what XLA's SPMD partitioner and
``shard_map`` do for the JAX package).

The JAX package places parameters with ``NamedSharding``s and lets XLA
insert the collectives.  torch has no partitioner, and its ``DTensor`` is
one rank per device, so two cells of one mesh cannot share a process.
Here a mesh's cells are run by one thread, explicitly:

* a :class:`ShardedTensor` is the global array of the reference: its
  spec, its global shape and dtype, and one shard a cell, each on its
  cell's device.  Cells that a spec replicates hold copies; cells on one
  device share one tensor for one block.
* the values of one quantity across the cells are a Python list indexed
  by cell (``Mesh.cell_devices`` order).  The collectives take such a
  list and the mesh axes they run over, and return the new list:
  ``psum`` moves each member of a group to the group's first cell with
  ``.to()`` and adds them in cell order (so every cell gets the same
  bits, whatever the devices), ``all_gather`` concatenates,
  ``all_to_all`` re-slices, ``ppermute`` rotates.  No thread runs them,
  so their order is fixed, and autograd passes through ``.to()``, ``+``
  and ``cat``: a loss computed over the cells has gradients with no
  custom ``autograd.Function``.  Between distinct cards these are peer
  copies; NCCL is not used here.  The same operations on one group's
  members (``sum_members``, ``gather_members``, ``swap_members``,
  ``rotate_members``) are what the ``*_kernel`` functions of ring.py,
  ulysses.py and pipeline.py call on their lists of stations.

A spec entry names a mesh axis, a tuple of axes (the dimension split
over their product, the first axis major) or None (replicated).  An axis
that the mesh lacks counts as size 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ant_ray_tpu_torch.parallel.mesh import mesh_axis_size


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, an axis name, or a tuple of
    axis names (as ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a spec, as ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

    @property
    def device_set(self) -> set:
        return self.mesh.device_set

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and _normal(self.spec) == _normal(other.spec))

    def __hash__(self):
        return hash((self.mesh, _normal(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _normal(spec):
    """A spec without its trailing Nones (they change nothing)."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(mesh, axes) -> int:
    """The number of cells along a spec entry's axes."""
    return mesh_axis_size(mesh, *_axes(axes))


def axis_index(mesh, cell: int, axes) -> int:
    """The cell's index along ``axes`` (mixed radix, the first axis
    major); 0 along axes the mesh lacks."""
    coords = mesh.coords(cell)
    index = 0
    for a in _axes(axes):
        index = index * mesh.shape.get(a, 1) + coords.get(a, 0)
    return index


def groups(mesh, axes) -> list[list[int]]:
    """The cells in groups that differ only along ``axes``, each group
    ordered by its index along them (kept on the mesh once made)."""
    axes = _axes(axes)
    made = mesh.__dict__.setdefault("_groups", {})
    if axes not in made:
        made[axes] = _groups(mesh, axes)
    return made[axes]


def _groups(mesh, axes) -> list[list[int]]:
    by_key: dict = {}
    for cell in range(mesh.size):
        coords = mesh.coords(cell)
        key = tuple(v for k, v in coords.items() if k not in axes)
        by_key.setdefault(key, []).append(cell)
    return [sorted(g, key=lambda c: axis_index(mesh, c, axes))
            for g in by_key.values()]


# The collectives of one group: ``values`` is the group's members in
# order, each on its own device; each returns the members' new values.

def sum_members(values: list) -> list:
    """Every member gets the sum of all, added in member order on the
    first member's device."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(values[0].device)
    return [total.to(v.device) for v in values]


def gather_members(values: list, dim: int) -> list:
    """Every member gets all values concatenated along ``dim``."""
    whole = torch.cat([v.to(values[0].device) for v in values], dim=dim)
    return [whole.to(v.device) for v in values]


def swap_members(values: list, split_dim: int, concat_dim: int) -> list:
    """Tiled all-to-all: each member splits its value into n pieces along
    ``split_dim``; member i gets piece i of every member, concatenated
    along ``concat_dim`` in member order."""
    n = len(values)
    pieces = [v.chunk(n, dim=split_dim) for v in values]
    return [torch.cat([pieces[j][i].to(v.device) for j in range(n)],
                      dim=concat_dim) for i, v in enumerate(values)]


def rotate_members(values: list, shift: int = 1) -> list:
    """Member j's value goes to member (j + shift) mod n."""
    n = len(values)
    return [values[(i - shift) % n].to(v.device)
            for i, v in enumerate(values)]


def _over_groups(collective, values: list, mesh, axes) -> list:
    """``collective`` (members → members) in every group along ``axes``."""
    out = list(values)
    for group in groups(mesh, axes):
        if len(group) > 1:
            for c, v in zip(group, collective([values[c] for c in group])):
                out[c] = v
    return out


def psum(values: list, mesh, axes) -> list:
    """Sum over ``axes``: every cell of a group gets the sum of the
    group's values, added in cell order on the group's first cell."""
    return _over_groups(sum_members, values, mesh, axes)


def all_gather(values: list, mesh, axes, dim: int) -> list:
    """Concatenate a group's values along ``dim``, in the group's order."""
    return _over_groups(lambda vs: gather_members(vs, dim), values, mesh,
                        axes)


def all_to_all(values: list, mesh, axes, split_dim: int,
               concat_dim: int) -> list:
    """Tiled all-to-all over ``axes`` (see :func:`swap_members`)."""
    return _over_groups(lambda vs: swap_members(vs, split_dim, concat_dim),
                        values, mesh, axes)


def ppermute(values: list, mesh, axes, shift: int = 1) -> list:
    """Member j's value goes to member (j + shift) mod n of its group."""
    return _over_groups(lambda vs: rotate_members(vs, shift), values, mesh,
                        axes)


def broadcast(values: list, mesh, axes, index: int) -> list:
    """Member ``index``'s value to every member of its group."""
    return _over_groups(lambda vs: [vs[index].to(v.device) for v in vs],
                        values, mesh, axes)


# ------------------------------------------------------------- shards

def _check_spec(spec, shape, mesh):
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    for dim, entry in enumerate(spec):
        parts = axis_size(mesh, entry)
        if shape[dim] % parts:
            raise ValueError(
                f"dimension {dim} of shape {tuple(shape)} is not divisible "
                f"by the {parts} cells of {entry!r}")


def block_of(spec, shape, mesh, cell: int) -> tuple:
    """The cell's block: one ``slice`` per dimension."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts = axis_size(mesh, entry)
        step = size // parts
        i = axis_index(mesh, cell, entry)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def same_blocks(spec_a, spec_b, shape, mesh) -> bool:
    """Whether two specs give every cell the same block of ``shape``."""
    return all(block_of(spec_a, shape, mesh, c)
               == block_of(spec_b, shape, mesh, c) for c in range(mesh.size))


def split(x: torch.Tensor, spec, mesh, *, non_blocking: bool = False
          ) -> list:
    """One block of ``x`` a cell, on the cell's device.  Cells on one
    device that hold the same block share one tensor.  A block is a
    contiguous tensor: a view of ``x`` where the block already is one on
    that device, else a copy.  Autograd passes through."""
    _check_spec(spec, x.shape, mesh)
    made: dict = {}
    out = []
    for cell, dev in enumerate(mesh.cell_devices):
        block = block_of(spec, x.shape, mesh, cell)
        key = (tuple((s.start, s.stop) for s in block), dev)
        if key not in made:
            made[key] = x[block].to(dev, non_blocking=non_blocking
                                    ).contiguous()
        out.append(made[key])
    return out


class ShardedTensor:
    """A global tensor laid out over a mesh: ``shards[cell]`` is the
    cell's block on the cell's device.  ``shape`` and ``dtype`` are the
    global ones; ``sharding`` is its NamedSharding."""

    def __init__(self, shards: list, sharding: NamedSharding, shape):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = self.shards[0].dtype

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self):
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The mesh's first cell's device."""
        return self.mesh.cell_devices[0]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first cell's),
        assembled from one shard of each block."""
        device = torch.device(device) if device is not None else self.device
        blocks: dict = {}
        for cell, shard in enumerate(self.shards):
            key = tuple(
                s.start // max(s.stop - s.start, 1)
                for s in block_of(self.spec, self.shape, self.mesh, cell))
            blocks.setdefault(key, shard)
        counts = [axis_size(self.mesh, self.spec[d] if d < len(self.spec)
                            else None) for d in range(self.ndim)]

        def assemble(prefix):
            dim = len(prefix)
            if dim == self.ndim:
                return blocks[prefix].to(device)
            parts = [assemble(prefix + (i,)) for i in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

        return assemble(())

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, {self.sharding!r})")


def shard(x, sharding: NamedSharding, *, non_blocking: bool = False
          ) -> ShardedTensor:
    """``x`` (a tensor, a numpy array or a ShardedTensor) laid out by
    ``sharding``.  A ShardedTensor already so is returned as it is; one
    laid out otherwise is assembled on each cell's device and split
    again."""
    if isinstance(x, ShardedTensor):
        if x.sharding == sharding:
            return x
        if x.mesh == sharding.mesh and same_blocks(
                x.spec, sharding.spec, x.shape, x.mesh):
            return ShardedTensor(x.shards, sharding, x.shape)
        fulls = {dev: x.full(dev) for dev in sharding.mesh.device_set}
        shards = []
        for cell, dev in enumerate(sharding.mesh.cell_devices):
            block = block_of(sharding.spec, x.shape, sharding.mesh, cell)
            shards.append(fulls[dev][block].contiguous())
        return ShardedTensor(shards, sharding, x.shape)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return ShardedTensor(split(x, sharding.spec, sharding.mesh,
                               non_blocking=non_blocking), sharding, x.shape)


def on_mesh(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` as a ShardedTensor on ``sharding``'s mesh: one already there
    as it is, in whatever layout; anything else laid out by
    ``sharding``."""
    if isinstance(x, ShardedTensor) and x.mesh == sharding.mesh:
        return x
    return shard(x, sharding)


def relayout_plan(mesh, have, want, shape):
    """The function that lays cells' blocks out by ``want`` instead of
    ``have``: as they are where the blocks agree, an all-gather over fsdp
    where ``want`` is ``have`` with its fsdp entries whole (a ZeRO-3
    gather), else assembled on each device and split again."""
    if same_blocks(have, want, shape, mesh):
        return lambda values: values
    gathered = tuple(None if e == "fsdp" else e for e in have)
    if same_blocks(gathered, want, shape, mesh):
        dims = [d for d, e in enumerate(have) if e == "fsdp"]

        def gather(values):
            for dim in dims:
                values = all_gather(values, mesh, "fsdp", dim)
            return values

        return gather
    have_s, want_s = NamedSharding(mesh, have), NamedSharding(mesh, want)
    return lambda values: shard(ShardedTensor(values, have_s, shape),
                                want_s).shards


def device_put(tree, shardings, *, non_blocking: bool = False):
    """Lay out every tensor of a (nested dict) ``tree``: ``shardings`` is
    one NamedSharding for all of them or a dict of the same structure."""
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k] if isinstance(shardings, dict)
                              else shardings, non_blocking=non_blocking)
                for k, v in tree.items()}
    return shard(tree, shardings, non_blocking=non_blocking)


def as_global(x):
    """A ShardedTensor assembled on its first cell's device; anything
    else as it is."""
    return x.full() if isinstance(x, ShardedTensor) else x


def full_tree(tree, device=None):
    """Every ShardedTensor of a nested dict assembled on ``device``
    (plain tensors moved there)."""
    if isinstance(tree, dict):
        return {k: full_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return tree.full(device)
    return tree if device is None else tree.to(device)


def mesh_of(tree):
    """The mesh of the first ShardedTensor in a nested dict, else None."""
    if isinstance(tree, dict):
        for v in tree.values():
            mesh = mesh_of(v)
            if mesh is not None:
                return mesh
        return None
    return tree.mesh if isinstance(tree, ShardedTensor) else None


def unique_shards(x: ShardedTensor) -> list:
    """Each distinct shard tensor once."""
    seen, out = set(), []
    for s in x.shards:
        if id(s) not in seen:
            seen.add(id(s))
            out.append(s)
    return out
