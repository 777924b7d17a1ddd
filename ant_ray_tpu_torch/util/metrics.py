"""User-defined metrics recorded to the GCS metrics table (a copy of
ant_ray_tpu/util/metrics.py, which the port does not import): ``Counter``,
``Gauge`` and ``Histogram`` send one ``MetricRecord`` payload per
observation through the runtime's oneway channel.  The GCS folds them
into series: counters accumulate, gauges overwrite, histograms keep a
count, a sum, per-bucket tallies and the latest exemplar
(``MetricsGet`` reads them back).

Best-effort, as in the reference: outside a cluster (no runtime, or
local mode) an observation is dropped.  Imports no torch: the tracing
plane, which the GCS and the node daemon load, reaches ``Histogram``
through it."""

from __future__ import annotations

import time


def _record(payload: dict):
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if not global_worker.connected:
        return  # metrics are best-effort outside a cluster
    runtime = global_worker.runtime
    gcs = getattr(runtime, "_gcs", None)
    if gcs is None:
        return  # local mode
    runtime._send_oneway(runtime.gcs_address, "MetricRecord", payload)


class _Metric:
    _type = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: tuple = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}

    def set_default_tags(self, tags: dict):
        self._default_tags = dict(tags)
        return self

    def _emit(self, value: float, tags: dict | None,
              extra: dict | None = None):
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        payload = {"name": self._name, "type": self._type,
                   "value": float(value), "tags": merged,
                   "description": self._description}
        if extra:
            payload.update(extra)
        _record(payload)


class Counter(_Metric):
    _type = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError("counters only increase")
        self._emit(value, tags)


class Gauge(_Metric):
    _type = "gauge"

    def set(self, value: float, tags: dict | None = None):
        self._emit(value, tags)


class Histogram(_Metric):
    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: list | None = None, tag_keys: tuple = ()):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(float(b) for b in (boundaries or []))

    def observe(self, value: float, tags: dict | None = None,
                exemplar: dict | None = None):
        # Boundaries ride along so the GCS can tally per-bucket counts.
        # An exemplar ({"trace_id": ...}) links the observation to a
        # concrete trace, OpenMetrics style: the GCS keeps the latest
        # per series.
        extra: dict = {"boundaries": self._boundaries}
        if exemplar:
            extra["exemplar"] = {"labels": dict(exemplar),
                                 "value": float(value),
                                 "ts": time.time()}
        self._emit(value, tags, extra=extra)
