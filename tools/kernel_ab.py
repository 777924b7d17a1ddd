#!/usr/bin/env python3
"""The flash-attention kernels of several checkouts, timed in turns on one
NVIDIA GPU:

    python3 tools/kernel_ab.py CHECKOUT [CHECKOUT ...]

A CHECKOUT is a directory holding a ``chip_smoke.py`` and an
``ant_ray_tpu_torch`` package, e.g. another commit unpacked with ``git
archive <commit> | tar -x -C <dir>``.  For each CHECKOUT in the order
given and then in reverse (A, B, B, A), one process builds that
checkout's kernels from its own sources and runs its chip_smoke.py
kernel phases, ``kernel_phase`` and ``bwd_kernel_phase``, gates as they
stand.  It prints one JSON line per fp32 row (the tf32x3 and
tf32x3_d256 routes): the forward's ms and max abs error of out, or
the dQ and dK/dV kernels' ms and errors over max |ref|, with the
CUDA-core kernels' ms where the phase timed them on the same inputs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def rows(checkout: str) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch  # noqa: PLC0415

    import chip_smoke as cs  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    head = {"checkout": os.path.abspath(checkout)}
    for r in cs.kernel_phase(torch, fa):
        if "float32" in r["shape"]:
            print("ab " + json.dumps({
                **head, "direction": "fwd", "shape": r["shape"],
                "route": r["route"], "ms": r["ms"],
                "out_err": r["max_abs_err"],
                "simt_ms": r.get("simt", {}).get("ms")}), flush=True)
    for r in cs.bwd_kernel_phase(torch, fa):
        if "float32" in r["shape"]:
            simt = r.get("simt")
            print("ab " + json.dumps({
                **head, "direction": "bwd", "shape": r["shape"],
                "route": r["route"], "dq_ms": r["kernels"]["dq"]["ms"],
                "dkv_ms": r["kernels"]["dkv"]["ms"],
                "rel_err": r["rel_err"],
                "simt_ms": simt and [simt["dq"]["ms"], simt["dkv"]["ms"]]}),
                flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        rows(args[1])
        return 0
    if not args:
        raise SystemExit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    for checkout in args + args[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        checkout], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
