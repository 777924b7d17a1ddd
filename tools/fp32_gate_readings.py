#!/usr/bin/env python3
"""What chip_smoke's fp32 gates read for a checkout, without gating: the
readings behind ``TOL["float32"]``, ``BWD_TOL["float32"]``, ``GRAD_TOL``
and ``GPT2_GRAD_TOL``, and those of ``GPT2_LOSS_TOL`` and
``GPT2_LOGIT_TOL`` in fp32.  One NVIDIA GPU:

    python3 tools/fp32_gate_readings.py [CHECKOUT]

CHECKOUT (default: this repository) is a directory holding a
``chip_smoke.py`` and an ``ant_ray_tpu_torch`` package; its kernels are
built from its own sources.  Point it at a copy whose fp32 kernels were
changed, e.g. to one TF32 product instead of three (in
``flash_attention_tf32x3.cuh``, shared by the forward and the backward,
``mma_3xtf32`` keeping only ``a.hi . b.hi``), to see whether each gate
tells that copy from the sound one.

Runs, with every tolerance of the checkout's chip_smoke set to infinity
(launch and route gates stay): its forward kernel phase (the fp32 rows:
max abs error of out and of lse), its backward kernel phase (the fp32
rows: max abs error over max |ref| per tensor), its fp32 gradient check
(per remat policy, against reference attention and the CPU) and its
GPT-2 fp32 phase (the gradients on the initial weights, the first loss
against plain fp32, the logits after training).  Prints one JSON line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(checkout: str) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch  # noqa: PLC0415

    import chip_smoke as cs  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("fp32_gate_readings: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    inf = math.inf
    cs.TOL = {name: (inf, inf) for name in cs.TOL}
    cs.BWD_TOL = {name: dict.fromkeys(tol, inf)
                  for name, tol in cs.BWD_TOL.items()}
    cs.GRAD_TOL = cs.GPT2_GRAD_TOL = inf
    cs.GPT2_LOSS_TOL = dict.fromkeys(cs.GPT2_LOSS_TOL, inf)
    cs.GPT2_LOGIT_TOL = dict.fromkeys(cs.GPT2_LOGIT_TOL, inf)

    rows = cs.kernel_phase(torch, fa)
    forward = {r["shape"]: {"route": r["route"], "out_err": r["max_abs_err"],
                            "lse_err": r["lse_err"]}
               for r in rows if "float32" in r["shape"]}
    rows = cs.bwd_kernel_phase(torch, fa)
    backward = {r["shape"]: {"route": r["route"], "rel_err": r["rel_err"]}
                for r in rows if "float32" in r["shape"]}
    _, grad_check = cs.grad_check_phase(torch, fa, llama)
    _, gpt2 = cs.gpt2_phase(torch, fa, "float32")
    return {"checkout": os.path.abspath(checkout),
            "source": str(_build.CSRC / "flash_attention_tf32x3.cuh"),
            "forward": forward, "backward": backward, "grad_check": grad_check, "gpt2": gpt2}


def main() -> int:
    checkout = sys.argv[1] if len(sys.argv) > 1 else ROOT
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    print(json.dumps(readings(checkout)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
