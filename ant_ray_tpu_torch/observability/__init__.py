"""ant_ray_tpu_torch.observability — instruments of the port (the
counterpart of ant_ray_tpu.observability): the per-step phase profiler
and per-card memory statistics."""

from ant_ray_tpu_torch.observability.device_stats import device_memory_stats
from ant_ray_tpu_torch.observability.step_profiler import (StepProfiler,
                                                           StepRecord)

__all__ = ["StepProfiler", "StepRecord", "device_memory_stats"]
