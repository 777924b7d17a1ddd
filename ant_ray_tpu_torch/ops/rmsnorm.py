"""RMSNorm (counterpart of ant_ray_tpu/ops/rmsnorm.py)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast back to x's dtype, *then* scale by the
    weight — the reference's order, which rounds before the multiply."""
    dtype = x.dtype
    x32 = x.float()
    scale = torch.reciprocal(
        torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps))
    return (x32 * scale).to(dtype) * weight
