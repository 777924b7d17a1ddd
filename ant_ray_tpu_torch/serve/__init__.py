"""Model serving (the port of ant_ray_tpu.serve; ref capability:
ray.serve — controller/replica reconciliation, deployment handles, HTTP
and gRPC ingress).  Importing it imports neither torch nor aiohttp nor
grpcio."""

from ant_ray_tpu_torch.serve.api import (
    CONTROLLER_NAME,
    Application,
    AutoscalingConfig,
    CircuitBreakerConfig,
    Deployment,
    DeploymentHandle,
    RequestRetryConfig,
    batch,
    deployment,
    get_multiplexed_model_id,
    get_request_deadline,
    multiplexed,
    run,
    shutdown,
)

__all__ = [
    "CONTROLLER_NAME",
    "Application",
    "AutoscalingConfig",
    "CircuitBreakerConfig",
    "Deployment",
    "DeploymentHandle",
    "RequestRetryConfig",
    "batch",
    "deployment",
    "get_multiplexed_model_id",
    "get_request_deadline",
    "multiplexed",
    "run",
    "shutdown",
]
