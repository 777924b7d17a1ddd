#!/usr/bin/env python3
"""The fp32 head_dim-256 Llama of chip_smoke.py (Gemma-2B's widths, 2.51 B
fp32 parameters, 2 x 2049 tokens, AdamW) under remat "none" and "full",
on one NVIDIA GPU: the measurement behind chip_smoke's
``D256_FP32_REMAT``.

    python3 tools/d256_fp32_remat.py

Per policy, from the same weights and optimizer, three ``train_step``
calls host-timed to the loss's ``item()``, and the peak
device memory; a policy that runs out of device memory is reported as
such.  One JSON line per policy, after the card's nvidia-smi line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("d256_fp32_remat: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    cfg, params, tokens = cs._llama_d256(torch, llama, torch.float32)
    optimizer = make_optimizer(params)
    for remat in ("none", "full"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"remat": remat, "params_b": cfg.num_params() / 1e9}
        try:
            step_ms, losses = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(train_step(params, optimizer, tokens, cfg,
                                         remat=remat).item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
            row.update(ok=True, step_ms=step_ms, losses=losses)
        except torch.cuda.OutOfMemoryError as e:
            row.update(ok=False, error=str(e).splitlines()[0])
            optimizer.zero_grad(set_to_none=True)
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
