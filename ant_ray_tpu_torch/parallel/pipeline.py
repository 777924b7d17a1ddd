"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis
(counterpart of ant_ray_tpu/parallel/pipeline.py).

Every stage runs the same code on its own layers; activations hop one
stage per tick, the last stage's outputs are handed back to every stage.
It composes with the other axes because it is just another mesh
dimension: each group of cells along ``pp`` runs its own pipeline.

Restriction (GPipe-standard): every stage preserves the activation
shape and dtype — true for transformer blocks.
"""

from __future__ import annotations

import torch

from ant_ray_tpu_torch.parallel import spmd


def _squeeze_stage(tree):
    if isinstance(tree, dict):
        return {k: _squeeze_stage(v) for k, v in tree.items()}
    return tree[0]


def gpipe_kernel(stage_fn, stage_params: list, microbatches: list) -> list:
    """The stages of one pipeline, ticked in one thread.

    In place of the reference's ``axis_name`` / ``axis_size``, the
    arguments are lists over the stages in order: ``stage_params[i]``
    stage i's params with a leading stage dim of 1, and
    ``microbatches[i]`` the (num_micro, ...) inputs as stage i holds
    them (identical on every stage).  At tick t stage i runs microbatch
    t - i; a stage in the bubble (no microbatch at that tick) gives
    zeros, as the reference masks it, and is not run.  Returns the last
    stage's (num_micro, ...) outputs, on every stage's device."""
    n = len(stage_params)
    params = [_squeeze_stage(p) for p in stage_params]
    num_micro = microbatches[0].shape[0]
    ticks = num_micro + n - 1
    pending = [torch.zeros_like(mb[0]) for mb in microbatches]
    last = []
    for t in range(ticks):
        ys = []
        for i in range(n):
            if 0 <= t - i < num_micro:
                x_in = microbatches[i][t] if i == 0 else pending[i]
                ys.append(stage_fn(params[i], x_in))
            else:
                ys.append(torch.zeros_like(pending[i]))
        last.append(ys[-1])
        # Stage i's output to stage i + 1 (the last stage's drops into
        # stage 0, which ignores it).
        pending = spmd.rotate_members(ys)
    out = torch.stack(last[n - 1:n - 1 + num_micro])
    return [out.to(mb.device) for mb in microbatches]


def gpipe(stage_fn, stacked_params, microbatches, *, mesh,
          axis_name: str = "pp", batch_axes=("dp", "fsdp")
          ) -> spmd.ShardedTensor:
    """Run a GPipe pipeline over global tensors.

    Args:
      stage_fn: (params, x) -> y with y.shape == x.shape.
      stacked_params: nested dict whose leaves have leading dim == pp
        degree (stage i's params at index i); split over the pp axis.
      microbatches: (num_micro, batch, ...) inputs; batch split over
        ``batch_axes``, replicated over pp.
    Returns the (num_micro, batch, ...) outputs as a ShardedTensor laid
    out like the microbatches."""
    param_sharding = spmd.NamedSharding(mesh, spmd.P(axis_name))
    x_sharding = spmd.NamedSharding(mesh, spmd.P(None, batch_axes))
    placed = spmd.device_put(stacked_params, param_sharding)
    xs = spmd.shard(microbatches, x_sharding)

    def cell_params(tree, cell):
        if isinstance(tree, dict):
            return {k: cell_params(v, cell) for k, v in tree.items()}
        return tree.shards[cell]

    out = [None] * mesh.size
    for group in spmd.groups(mesh, axis_name):
        got = gpipe_kernel(stage_fn, [cell_params(placed, c) for c in group],
                           [xs.shards[c] for c in group])
        for c, o in zip(group, got):
            out[c] = o
    return spmd.ShardedTensor(out, x_sharding, xs.shape)
