"""Carry weights (and KV caches) from the JAX package into the port.

The JAX package keeps a model's parameters as a nested dict of arrays;
``jax.tree.map(np.asarray, params)`` turns it into numpy.  The port keeps
the same leaf names and layouts, so the conversion is leaf by leaf with
no transpose.  The port imports nothing of JAX: this module takes numpy
arrays (bf16 ones as ``ml_dtypes.bfloat16``, read bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.models import gpt2, llama


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(arr)                   # a writable copy for torch
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.is_floating_point():
        t = t.to(dtype)
    else:
        t = t.to(torch.int64)     # lengths and other indices
    return t.to(device)


def _check_shapes(tree: dict, shapes: dict, path: str = ""):
    if set(tree) != set(shapes):
        raise ValueError(f"leaves {sorted(tree)} at {path or 'top'} do not "
                         f"match the config's {sorted(shapes)}")
    for name, want in shapes.items():
        if isinstance(want, dict):
            _check_shapes(tree[name], want, f"{path}{name}.")
        elif tuple(np.shape(tree[name])) != tuple(want):
            raise ValueError(f"{path}{name}: shape {np.shape(tree[name])}, "
                             f"config wants {want}")


def params_from_jax_numpy(tree: dict,
                          config: llama.LlamaConfig | gpt2.Gpt2Config,
                          device=None) -> dict:
    """A nested dict of numpy arrays from the JAX package → the same
    dict of tensors on ``device``: floating leaves in ``config.dtype``,
    integer leaves as int64.

    Works for a parameter tree of either family (checked leaf by leaf
    against the ``param_shapes`` of the config's family) and for a
    Llama KV cache from ``init_kv_cache`` / the serving functions
    (``k``, ``v``, ``length``)."""
    device = resolve_device(device)
    if "layers" in tree:
        family = gpt2 if isinstance(config, gpt2.Gpt2Config) else llama
        _check_shapes(tree, family.param_shapes(config))

    def convert(node):
        if isinstance(node, dict):
            return {name: convert(leaf) for name, leaf in node.items()}
        return _tensor(node, config.dtype, device)

    return convert(tree)
