"""Per-device memory statistics of the CUDA caching allocator (a port of
ant_ray_tpu/observability/device_stats.py, which reads
``jax.Device.memory_stats()`` and which the port does not import).

Per card: ``bytes_in_use`` (``torch.cuda.memory_allocated``),
``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``, since the
last ``reset_peak_memory_stats``) and ``bytes_limit`` (the card's total
memory).  Without a card there is one ``cpu`` entry whose ``bytes_*``
fields are ``None``, the reference's contract on a CPU backend.

:func:`device_stats_gauges` turns the entries into gauge series in the
``MetricRecord`` wire format, as the reference does.  The reference's node
agent publishes them on an interval (``device_stats_interval_s``); the
port has no node agent yet (ROADMAP.md queue A item 6.6), so a caller
publishes them itself, e.g. through ``util/metrics.py`` ``Gauge``.
"""

from __future__ import annotations

import torch


def _devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_memory_stats(devices=None) -> list[dict]:
    """One entry per local device (default: every CUDA card, else the
    CPU).  ``bytes_*`` fields are ints on a card and ``None`` on the CPU
    — the CPU-graceful contract callers rely on."""
    out = []
    for i, dev in enumerate(_devices() if devices is None else devices):
        dev = torch.device(dev)
        cuda = dev.type == "cuda"
        entry: dict = {
            "index": i,
            "device": str(dev),
            "platform": "gpu" if cuda else dev.type,   # JAX's name
            "bytes_in_use": None,
            "peak_bytes_in_use": None,
            "bytes_limit": None,
        }
        if cuda:
            entry["bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
            entry["peak_bytes_in_use"] = int(
                torch.cuda.max_memory_allocated(dev))
            entry["bytes_limit"] = int(
                torch.cuda.get_device_properties(dev).total_memory)
        out.append(entry)
    return out



def device_stats_gauges(stats: list[dict] | None = None) -> list[dict]:
    """Prometheus-shaped gauge series (the node-metrics wire format:
    name/type/value/tags/description), tagged ``device`` and
    ``platform``.  Devices without memory stats (the CPU) contribute
    nothing."""
    if stats is None:
        stats = device_memory_stats()
    series = []
    for entry in stats:
        tags = {"device": str(entry.get("device", entry.get("index"))),
                "platform": entry.get("platform", "unknown")}
        for field, name, desc in (
                ("bytes_in_use", "art_device_hbm_bytes_in_use",
                 "device memory currently allocated"),
                ("peak_bytes_in_use", "art_device_hbm_peak_bytes",
                 "high-water device memory"),
                ("bytes_limit", "art_device_hbm_bytes_limit",
                 "device memory capacity")):
            value = entry.get(field)
            if value is None:
                continue
            series.append({"name": name, "type": "gauge",
                           "value": float(value), "tags": dict(tags),
                           "description": desc})
    return series
