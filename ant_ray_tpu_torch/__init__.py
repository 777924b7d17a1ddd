"""ant_ray_tpu_torch — the PyTorch/CUDA port of ant_ray_tpu.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``llm/``, ``_private/``, ``api.py``) and imports neither JAX nor anything
of ``ant_ray_tpu``.  Plain tensor code is PyTorch; every TPU kernel on a
ported path is a kernel written by hand for Hopper (``ops/csrc/``), built
on first use.

Every entry point runs on the current CUDA device unless the caller
passes ``device="cpu"``; without a GPU and without that, it raises.

The runtime's API (``init(local_mode=True)``, ``remote``, ``get``,
``put``, ``wait``, actors) is exported here as in the JAX package, and
loaded on first use, so ``import ant_ray_tpu_torch`` imports neither
torch nor the runtime.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "ClientContext": "ant_ray_tpu_torch.api",
    "available_resources": "ant_ray_tpu_torch.api",
    "cancel": "ant_ray_tpu_torch.api",
    "cluster_resources": "ant_ray_tpu_torch.api",
    "get": "ant_ray_tpu_torch.api",
    "get_actor": "ant_ray_tpu_torch.api",
    "init": "ant_ray_tpu_torch.api",
    "is_initialized": "ant_ray_tpu_torch.api",
    "kill": "ant_ray_tpu_torch.api",
    "method": "ant_ray_tpu_torch.api",
    "nodes": "ant_ray_tpu_torch.api",
    "put": "ant_ray_tpu_torch.api",
    "remote": "ant_ray_tpu_torch.api",
    "shutdown": "ant_ray_tpu_torch.api",
    "wait": "ant_ray_tpu_torch.api",
    "ObjectRef": "ant_ray_tpu_torch.object_ref",
    "RemoteFunction": "ant_ray_tpu_torch.remote_function",
    "ActorClass": "ant_ray_tpu_torch.actor",
    "ActorHandle": "ant_ray_tpu_torch.actor",
    "resolve_device": "ant_ray_tpu_torch._device",
}

__all__ = sorted([*_EXPORTS, "exceptions"])


def __getattr__(name: str):
    if name == "exceptions":
        return importlib.import_module("ant_ray_tpu_torch.exceptions")
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'ant_ray_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
