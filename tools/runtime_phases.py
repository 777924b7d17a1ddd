#!/usr/bin/env python3
"""chip_smoke.py's runtime, objects and cluster phases alone, on one
NVIDIA GPU:

    python3 tools/runtime_phases.py [CHECKOUT]

Builds CHECKOUT's kernels (default: this checkout), makes Llama-3-8B's
weights at its published widths (random, seed 0) through its
``LLMEngine``, and runs its chip_smoke.py ``runtime_phase`` (an actor
holding an 8B engine in local mode, tokens against the same engine
called directly, and the runtime's own cost per no-op call),
``objects_phase`` (a 0.537 GB KV slab and a mixed dict through the
object store's native arena and back onto the card) and
``cluster_phase`` (a GCS, a node daemon and worker processes: an actor
building the 8B engine in its own process on the card, a second card
actor waiting for it, a CUDA tensor and the slab across processes,
no-op calls, and a shutdown that leaves nothing behind), gates
included.  Prints the card's nvidia-smi line and the phases' ``runtime``,
``objects`` and ``cluster`` JSON lines; exits non-zero if a gate fails
(the cluster phase prints its workers' logs first).

To compare two commits' object plane, unpack one with ``git archive
<commit> | tar -x -C <dir>`` and run the script on both in turns (A, B,
B, A), one process each, in one call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ROOT)
    sys.path.insert(0, checkout)
    import torch

    if not torch.cuda.is_available():
        print("runtime_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMEngine  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, f"checkout {checkout}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    params = LLMEngine("llama3-8b", slots=1, max_seq=4096, seed=0).params
    engine = chip_smoke.runtime_phase(torch, fa, llama, params)
    chip_smoke.objects_phase(torch, engine, card)
    chip_smoke.cluster_phase(torch, fa, llama, params, engine, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
