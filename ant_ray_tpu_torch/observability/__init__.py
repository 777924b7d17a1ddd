"""ant_ray_tpu_torch.observability — instruments of the port (the
counterpart of ant_ray_tpu.observability): the per-step phase profiler,
per-card memory statistics and the request-level tracing plane
(``tracing_plane``).

Exports are loaded on first use: the GCS and the node daemon import
``tracing_plane`` from here and must never load torch, which the
profiler and the memory statistics import."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "device_memory_stats": "ant_ray_tpu_torch.observability.device_stats",
    "StepProfiler": "ant_ray_tpu_torch.observability.step_profiler",
    "StepRecord": "ant_ray_tpu_torch.observability.step_profiler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'ant_ray_tpu_torch.observability' has no attribute "
            f"{name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
