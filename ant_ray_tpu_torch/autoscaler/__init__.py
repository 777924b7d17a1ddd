"""Autoscaler (ref capability: ray.autoscaler v2 — demand-driven node
provisioning over pluggable node providers).  The port of the JAX
package's ``autoscaler/``; ``tpu_slice_node_type`` raises (ROADMAP queue
A item 9)."""

from ant_ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
)
from ant_ray_tpu_torch.autoscaler.node_provider import (
    GkeApiError,
    GkeRestNodePoolClient,
    GkeTpuNodePoolProvider,
    LocalSubprocessProvider,
    NodeProvider,
    NodeTypeConfig,
    tpu_slice_node_type,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "GkeApiError",
    "GkeRestNodePoolClient",
    "GkeTpuNodePoolProvider",
    "LocalSubprocessProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "tpu_slice_node_type",
]
