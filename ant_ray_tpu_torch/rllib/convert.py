"""Carry RLlib weights from the JAX package into the port.

The JAX package keeps an algorithm's parameters as a tree of dicts and
lists of arrays; ``jax.tree.map(np.asarray, params)`` turns it into
numpy.  The port keeps the same leaf names and layouts (``w`` as
``(fan_in, fan_out)``), so the conversion is leaf by leaf with no
transpose.  The port imports nothing of JAX: this module takes numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device


def _check_tower(layers, path: str) -> None:
    """An MLP tower: ``{"w": (fan_in, fan_out), "b": (fan_out,)}``
    layers, each taking the width the one before it gives."""
    width = None
    for i, layer in enumerate(layers):
        where = f"{path}[{i}]"
        if not isinstance(layer, dict) or set(layer) != {"w", "b"}:
            raise ValueError(f"{where}: a layer is {{'w', 'b'}}, got "
                             f"{sorted(layer) if isinstance(layer, dict) else type(layer).__name__}")
        w, b = np.shape(layer["w"]), np.shape(layer["b"])
        if len(w) != 2 or b != (w[1],):
            raise ValueError(f"{where}: w {w} and b {b} do not make a "
                             "(fan_in, fan_out) layer")
        if width is not None and w[0] != width:
            raise ValueError(f"{where}.w: fan_in {w[0]}, the layer before "
                             f"gives {width}")
        width = w[1]


def _check(node, path: str) -> None:
    if isinstance(node, list):
        _check_tower(node, path or "layers")
    elif isinstance(node, dict):
        for name, child in node.items():
            where = f"{path}.{name}" if path else name
            if name == "log_alpha":
                if np.shape(child) != ():
                    raise ValueError(f"{where}: shape {np.shape(child)}, "
                                     "a scalar wanted")
            else:
                _check(child, where)
    else:
        raise ValueError(f"{path or 'top'}: a leaf where a tower of "
                         "layers or a dict of towers belongs")


def params_from_jax_numpy(tree, device=None):
    """A numpy tree from the JAX package's RLlib (PPO's ``{"pi", "vf"}``,
    the twin critics' ``{"q1", "q2"}``, DQN's list of layers, SAC's
    ``{"pi", "q", "q_target", "log_alpha"}``) → the same tree of float32
    tensors on ``device``.  Every tower is checked layer by layer:
    ``w`` is ``(fan_in, fan_out)``, ``b`` is ``(fan_out,)`` and each
    ``fan_in`` is the width of the layer before."""
    device = resolve_device(device)
    _check(tree, "")

    def convert(node):
        if isinstance(node, dict):
            return {name: convert(child) for name, child in node.items()}
        if isinstance(node, list):
            return [convert(child) for child in node]
        return torch.from_numpy(np.array(node, np.float32)).to(device)

    return convert(tree)
