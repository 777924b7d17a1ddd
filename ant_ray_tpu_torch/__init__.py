"""ant_ray_tpu_torch — the PyTorch/CUDA port of ant_ray_tpu.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``llm/``) and imports neither JAX nor anything of ``ant_ray_tpu``.  Plain
tensor code is PyTorch; every TPU kernel on a ported path is a kernel
written by hand for Hopper (``ops/csrc/``), built on first use.

Every entry point runs on the current CUDA device unless the caller
passes ``device="cpu"``; without a GPU and without that, it raises.
"""

from ant_ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
