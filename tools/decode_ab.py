#!/usr/bin/env python3
"""Decode of another checkout's ant_ray_tpu_torch against this one's, on
one NVIDIA GPU, at Llama-3-8B's published widths (random weights, seed
0):

    python3 tools/decode_ab.py [CHECKOUT] [--sessions]

Loads ``ant_ray_tpu_torch/models/llama.py`` of CHECKOUT (default: this
checkout) as a module of its own and, with its ``decode_step``:

1. times one decode step of 8 slots at context 1024 (slabs of 4096
   positions): CUDA-event median of 10, and a torch.profiler line with
   the device's busy share;
2. checks whether slot 0's logits stay bitwise equal when the other,
   inactive, slots hold 100, 1000 or 3000 tokens;
3. with ``--sessions``, runs this checkout's chip_smoke.py sessions
   phase with that ``decode_step`` in place of its own and prints
   whether its gates held (every turn's tokens equal to a run where each
   session decodes alone).

To compare two commits, unpack one with ``git archive <commit> | tar -x
-C <dir>`` and run the script on both in turns (A, B, B, A) in one
process each.
"""

from __future__ import annotations

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a for a in sys.argv[1:] if a != "--sessions"]
    checkout = os.path.abspath(args[0] if args else ROOT)
    import chip_smoke  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    spec = importlib.util.spec_from_file_location(
        "_decode_ab_llama",
        os.path.join(checkout, "ant_ray_tpu_torch", "models", "llama.py"))
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other      # dataclasses look their module up
    spec.loader.exec_module(other)
    decode_step = other.decode_step

    cfg = llama.CONFIGS["llama3-8b"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    cache = llama.init_kv_cache(cfg, 8, 4096, device="cuda")
    last = torch.zeros((8,), dtype=torch.int64, device="cuda")
    label = f"decode of {checkout}"
    with torch.inference_mode():
        def step():
            cache["length"].fill_(1024)
            decode_step(params, last, cache, cfg)

        ms = chip_smoke._median_ms(torch, step)
        print(f"{label}: {ms:.2f} ms per step of 8 slots at context 1024",
              flush=True)
        chip_smoke._profile(torch, label, step)

        gen = torch.Generator(device="cuda").manual_seed(3)
        for name in ("k", "v"):
            cache[name].copy_(torch.randn(cache[name].shape, generator=gen,
                                          device="cuda"))
        active = torch.zeros((8,), dtype=torch.bool, device="cuda")
        active[0] = True
        outs = []
        for others in (100, 1000, 3000):
            cache["length"].fill_(others)
            cache["length"][0].fill_(1024)
            logits, _ = decode_step(params, last, cache, cfg, active=active)
            outs.append(logits[0].clone())
    print(f"{label}: slot 0's logits bitwise equal with the other slots at "
          f"100 / 1000 / 3000 tokens: "
          f"{[torch.equal(outs[0], o) for o in outs[1:]]}, max abs "
          f"difference {[(outs[0] - o).abs().max().item() for o in outs[1:]]}",
          flush=True)
    del cache
    if "--sessions" in sys.argv[1:]:
        llama.decode_step = decode_step
        try:
            chip_smoke.sessions_phase(torch, fa, llama, params)
            print(f"{label}: sessions gates held", flush=True)
        except AssertionError as exc:
            print(f"{label}: sessions gates failed: {exc}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
