"""Per-device memory statistics (a port of
ant_ray_tpu/observability/device_stats.py, which reads
``jax.Device.memory_stats()`` and which the port does not import).

Two readings, one entry shape (``index``, ``device``, ``platform``,
``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``):

* :func:`device_memory_stats` — the calling process's CUDA caching
  allocator: ``torch.cuda.memory_allocated``, ``max_memory_allocated``
  (since the last ``reset_peak_memory_stats``) and the card's total
  memory.  A process that holds no tensor reads 0 here, and its first
  call opens a CUDA context on every card it reads.
* :func:`card_memory_stats` — the whole card, whoever holds the memory:
  NVML's ``nvmlDeviceGetMemoryInfo`` through ``ctypes`` on the driver's
  ``libnvidia-ml.so.1``.  It imports no torch and opens no CUDA
  context, so the node agent publishes it.  NVML keeps no peak, so
  ``peak_bytes_in_use`` is ``None`` there.

Without a card both give one ``cpu`` entry whose ``bytes_*`` fields are
``None``, the reference's contract on a CPU backend.  On a host that has
cards, :func:`card_memory_stats` raises when NVML cannot be read: it
never reports 0 for a card it could not see.

:func:`device_stats_gauges` turns the entries into gauge series in the
``MetricRecord`` wire format, as the reference does; the node agent
publishes the card-wide reading every ``device_stats_interval_s``.
"""

from __future__ import annotations

import ctypes
import os

_CPU_ENTRY = {"index": 0, "device": "cpu", "platform": "cpu",
              "bytes_in_use": None, "peak_bytes_in_use": None,
              "bytes_limit": None}


def _devices():
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_memory_stats(devices=None) -> list[dict]:
    """One entry per local device (default: every CUDA card, else the
    CPU), read from this process's caching allocator.  ``bytes_*``
    fields are ints on a card and ``None`` on the CPU — the CPU-graceful
    contract callers rely on."""
    import torch  # noqa: PLC0415

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


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


_nvml = None


def _nvml_lib():
    """The driver's NVML, initialised once per process."""
    global _nvml
    if _nvml is None:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        for name, argtypes in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetCount_v2", [ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetMemoryInfo",
                 [ctypes.c_void_p, ctypes.POINTER(_NvmlMemory)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        rc = lib.nvmlInit_v2()
        if rc != 0:
            raise RuntimeError(f"nvmlInit_v2 failed with NVML error {rc}")
        _nvml = lib
    return _nvml


def _visible_indices(count: int) -> list[int]:
    """NVML indices of the cards this process is given: every card, or
    those a ``CUDA_VISIBLE_DEVICES`` list of integers names (the mask's
    order is the CUDA ordinal's)."""
    mask = os.environ.get("CUDA_VISIBLE_DEVICES")
    if mask is None:
        return list(range(count))
    out = []
    for part in mask.split(","):
        part = part.strip()
        if not part.isdigit() or int(part) >= count:
            break           # CUDA stops at the first entry it cannot use
        out.append(int(part))
    return out


def card_memory_stats() -> list[dict]:
    """One entry per card this host gives its processes, read through
    NVML: ``bytes_in_use`` is the card's used memory, whichever process
    holds it, ``bytes_limit`` its total, ``peak_bytes_in_use`` ``None``.
    Opens no CUDA context and imports no torch.  Without a card, the
    ``cpu`` entry; with cards and no readable NVML, raises."""
    from ant_ray_tpu_torch._private.accelerators import gpu  # noqa: PLC0415

    if gpu.num_gpus() == 0:
        return [dict(_CPU_ENTRY)]
    try:
        lib = _nvml_lib()
    except OSError as e:
        raise RuntimeError(
            f"this host has a card but NVML cannot be loaded ({e}); card "
            "memory is not reported as 0") from e
    count = ctypes.c_uint()
    rc = lib.nvmlDeviceGetCount_v2(ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"nvmlDeviceGetCount_v2 failed with NVML error "
                           f"{rc}")
    out = []
    for ordinal, index in enumerate(_visible_indices(count.value)):
        handle = ctypes.c_void_p()
        rc = lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index),
                                               ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetHandleByIndex_v2({index}) "
                               f"failed with NVML error {rc}")
        mem = _NvmlMemory()
        rc = lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetMemoryInfo({index}) failed "
                               f"with NVML error {rc}")
        out.append({"index": ordinal, "device": f"cuda:{ordinal}",
                    "platform": "gpu", "bytes_in_use": int(mem.used),
                    "peak_bytes_in_use": None,
                    "bytes_limit": int(mem.total)})
    if not out:
        raise RuntimeError("NVML lists no card this process is given")
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
