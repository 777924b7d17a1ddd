"""ant_ray_tpu_torch.observability — instruments of the port (the
counterpart of ant_ray_tpu.observability): the per-step phase profiler
(``StepProfiler``, whose records publish to the GCS step-events table),
per-card memory statistics and their gauge series
(``device_memory_stats``, ``device_stats_gauges``), the request-level
tracing plane (``tracing_plane``, ``TraceContext``, ``FlightRecorder``)
and the continuous CPU profiler every process class runs
(``cpu_profiler``, a submodule outside ``__all__``, as in the JAX
package).

Exports are loaded on first use: the GCS and the node daemon import
``tracing_plane`` and ``cpu_profiler`` from here and must never load
torch, which the step profiler and the memory statistics import."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "device_memory_stats": "ant_ray_tpu_torch.observability.device_stats",
    "device_stats_gauges": "ant_ray_tpu_torch.observability.device_stats",
    "FlightRecorder": "ant_ray_tpu_torch.observability.tracing_plane",
    "TraceContext": "ant_ray_tpu_torch.observability.tracing_plane",
    "StepProfiler": "ant_ray_tpu_torch.observability.step_profiler",
    "StepRecord": "ant_ray_tpu_torch.observability.step_profiler",
}

__all__ = sorted([*_EXPORTS, "tracing_plane"])


def __getattr__(name: str):
    if name in ("cpu_profiler", "tracing_plane"):
        return importlib.import_module(
            f"ant_ray_tpu_torch.observability.{name}")
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'ant_ray_tpu_torch.observability' has no attribute "
            f"{name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
