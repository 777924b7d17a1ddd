"""ant_ray_tpu_torch.serve — the start of the port of ant_ray_tpu.serve:
the request-deadline context that LLMServer reads.  Deployments, the
router and the HTTP ingress need the runtime and are not ported yet
(ROADMAP.md)."""

from ant_ray_tpu_torch.serve.api import get_request_deadline

__all__ = ["get_request_deadline"]
