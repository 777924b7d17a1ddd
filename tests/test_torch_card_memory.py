"""The card-wide memory reading of ``observability/device_stats.py``
(``card_memory_stats``: NVML through ``ctypes``), which the node agent
publishes as ``art_device_hbm_*`` gauges.  On a host without a card it
gives the JAX package's CPU entry and no series, and a card NVML cannot
read raises instead of reading 0; it follows ``CUDA_VISIBLE_DEVICES``.
The card test (marked ``gpu``, skipped here) holds the reading against a
4-GiB tensor and shows that a fresh process reading it loads no torch
and opens no CUDA context.  This file imports no JAX, so the card's
machine runs it: ``python -m pytest --noconftest -m gpu
tests/test_torch_card_memory.py``."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_card_memory_stats_on_a_host_without_a_card(monkeypatch):
    """No card: the reference's CPU entry and no series.  A card that
    NVML cannot read raises; it is never reported as 0."""
    from ant_ray_tpu_torch._private.accelerators import gpu
    from ant_ray_tpu_torch.observability import device_stats

    monkeypatch.setattr(gpu, "num_gpus", lambda: 0)
    stats = device_stats.card_memory_stats()
    assert stats == [{"index": 0, "device": "cpu", "platform": "cpu",
                      "bytes_in_use": None, "peak_bytes_in_use": None,
                      "bytes_limit": None}]
    assert device_stats.device_stats_gauges(stats) == []
    monkeypatch.setattr(gpu, "num_gpus", lambda: 1)
    monkeypatch.setattr(device_stats, "_nvml", None)

    def no_library(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(device_stats.ctypes, "CDLL", no_library)
    with pytest.raises(RuntimeError, match="NVML cannot be loaded"):
        device_stats.card_memory_stats()


@pytest.mark.parametrize("mask,count,want", [
    (None, 2, [0, 1]), ("1", 2, [1]), ("1,0", 2, [1, 0]),
    ("0,7", 2, [0]), ("GPU-abc", 2, [])])
def test_card_memory_stats_follow_the_visible_cards(monkeypatch, mask,
                                                    count, want):
    from ant_ray_tpu_torch.observability import device_stats

    if mask is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", mask)
    assert device_stats._visible_indices(count) == want


@pytest.mark.gpu
def test_nvml_reading_sees_a_4_gib_tensor_and_opens_no_context():
    """On the card: the NVML reading rises by at least 4 GiB while this
    process holds a 4-GiB tensor, and a fresh process that reads it
    loads no torch and is not among the card's compute processes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NVML reads a real card")
    from ant_ray_tpu_torch.observability import device_stats

    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    before = device_stats.card_memory_stats()[0]["bytes_in_use"]
    held = torch.ones(4 << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    during = device_stats.card_memory_stats()[0]["bytes_in_use"]
    del held
    torch.cuda.empty_cache()
    assert during - before >= 4 << 30, (before, during)
    code = (
        "import os, subprocess, sys\n"
        "from ant_ray_tpu_torch.observability import device_stats\n"
        "stats = device_stats.card_memory_stats()\n"
        "apps = subprocess.run(['nvidia-smi', '--query-compute-apps=pid',\n"
        "    '--format=csv,noheader'], capture_output=True, text=True,\n"
        "    timeout=60).stdout.split()\n"
        "print(stats[0]['bytes_in_use'] > 0, 'torch' in sys.modules,\n"
        "      str(os.getpid()) in apps)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False", "False"]
