#!/usr/bin/env python3
"""The host's share of training and inference steps, for the
ant_ray_tpu_torch of CHECKOUT (default: this checkout), on one NVIDIA
GPU:

    python3 tools/train_host_ab.py [CHECKOUT] [--profile DIR]

At shapes where the card's work is a few milliseconds, so that the wall
time is the host's dispatch of every op:

1. ``attention(q, k, v, impl="flash")`` forward and backward at B=1
   S=128 H=8 KVH=4 D=128 bf16 (one launch of each flash kernel), host
   clock around each call and a synchronise, 50 calls;
2. llama-400m's ``forward`` on 1 x 128 tokens under
   ``torch.inference_mode()`` (the serving side of the same layers),
   20 calls;
3. llama-400m's ``train_step`` on 1 x 129 tokens under each remat
   policy, 15 calls after 3 warm-up; a policy the checkout does not
   take is reported with its error.

Each figure is [median, min] ms.  With ``--profile DIR``, 5 more steps
of item 3 per policy run under ``cProfile``, and the 40 functions with
the most time of their own go to ``DIR/host_profile_<policy>.txt``.

Prints one JSON line.  To compare two commits, unpack one with ``git
archive <commit> | tar -x -C <dir>`` and run the script on each in turns
(A, B, B, A) in one chip call, one process each.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ms(torch, fn, reps, warmup):
    """[median, min] ms of ``reps`` timed calls after ``warmup``: the
    host's share of one call, and the least of it (neighbours on a
    shared host only ever add time)."""
    times = []
    for _ in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(times[warmup:]), min(times[warmup:])]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_host_ab: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("checkout", nargs="?", default=ROOT)
    parser.add_argument("--profile", metavar="DIR")
    args = parser.parse_args()
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import ant_ray_tpu_torch  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops.attention import attention  # noqa: PLC0415
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    if not ant_ray_tpu_torch.__file__.startswith(checkout + os.sep):
        raise RuntimeError(f"imported {ant_ray_tpu_torch.__file__}, not "
                           f"the package of {checkout}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()

    q, k, v = rand(1, 128, 8, 128), rand(1, 128, 4, 128), rand(1, 128, 4,
                                                                128)

    def flash_fwd_bwd():
        out = attention(q, k, v, causal=True, impl="flash")
        torch.autograd.grad(out.sum(), (q, k, v))

    result = {"checkout": checkout,
              "flash_fwd_bwd_ms": _ms(torch, flash_fwd_bwd, 50, 5)}

    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 129), device="cuda",
                           generator=gen)

    def infer():
        with torch.inference_mode():
            llama.forward(params, tokens[:, :128], cfg)

    result["forward_1x128_ms"] = _ms(torch, infer, 20, 2)
    optimizer = make_optimizer(params)
    steps = {}
    for remat in ("none", "full", "dots", "matmuls"):
        try:
            steps[remat] = _ms(torch, lambda: train_step(
                params, optimizer, tokens, cfg, remat=remat).item(), 15, 3)
        except NotImplementedError:
            steps[remat] = "raises NotImplementedError"
    result["train_step_1x128_ms"] = steps
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        for remat in (r for r, ms in steps.items() if isinstance(ms, list)):
            profiler = cProfile.Profile()
            profiler.enable()
            for _ in range(5):
                train_step(params, optimizer, tokens, cfg,
                           remat=remat).item()
            profiler.disable()
            text = io.StringIO()
            pstats.Stats(profiler, stream=text).sort_stats(
                "tottime").print_stats(40)
            with open(os.path.join(args.profile,
                                   f"host_profile_{remat}.txt"), "w") as f:
                f.write(text.getvalue())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
