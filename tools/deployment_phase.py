#!/usr/bin/env python3
"""chip_smoke.py's deployment phase alone (and, with ``--tracing``, its
tracing phase after it), on one NVIDIA GPU:

    python3 tools/deployment_phase.py [--tracing] [CHECKOUT]

Builds CHECKOUT's kernels (default: this checkout) and runs its
chip_smoke.py ``deployment_phase``: build_llm_deployment serving
Llama-3-8B (random weights, seed 0) from three replicas in a cluster of
the port, requests through the handle and over HTTP, a session around
two idle evictions through the object-plane store, a slab through a
KvVault, gates included.  Prints the card's nvidia-smi line, the
Python, torch and CUDA versions and whether aiohttp, grpcio and
transformers are installed, then the phase's ``deployment`` lines and
its launches; exits non-zero if a gate fails (the phase prints its
workers' logs first).  About 75-110 s with the build.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    args = sys.argv[1:]
    tracing = "--tracing" in args
    args = [a for a in args if a != "--tracing"]
    checkout = os.path.abspath(args[0] if args else ROOT)
    sys.path.insert(0, checkout)
    import torch

    if not torch.cuda.is_available():
        print("deployment_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415

    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, f"checkout {checkout}", sys.version.split()[0],
          torch.__version__, torch.version.cuda,
          {m: importlib.util.find_spec(m) is not None
           for m in ("aiohttp", "grpc", "transformers")}, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    phases = ["deployment"] + (["tracing"] if tracing else [])
    for name in phases:
        t0 = time.perf_counter()
        launches = getattr(chip_smoke, f"{name}_phase")(torch, llama, card)
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s, launches "
              f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
