"""Device resolution: the port runs on the GPU unless the caller asks
for the CPU by name.  There is no silent fallback: with no GPU and no
explicit ``device="cpu"``, every entry point raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given, after checking that a CUDA device exists when one is named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ant_ray_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
