"""Ops: attention (blockwise / hand-written CUDA flash dispatch), rotary
embeddings, rmsnorm."""

from ant_ray_tpu_torch.ops.attention import attention, blockwise_attention
from ant_ray_tpu_torch.ops.rmsnorm import rmsnorm
from ant_ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "apply_rope",
    "attention",
    "blockwise_attention",
    "rmsnorm",
    "rope_frequencies",
]
