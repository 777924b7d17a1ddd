#!/usr/bin/env python3
"""Where a PPO iteration's time goes on one NVIDIA GPU:

    python3 tools/rllib_profile.py [--iterations N] [--trace PATH]

Builds chip_smoke's RLlib configuration (PPO on CartPole-v1, the
reference's learning test: 2 runners x 8 envs x 128 steps, 6 epochs of
256-row minibatches, seed 0) on the card, runs one iteration to warm
up, then profiles N more (default 2) with ``torch.profiler`` (CPU and
CUDA activities), the runners' sampling and the learner's update under
``record_function`` ranges of their own.  Prints one JSON line: the
card's nvidia-smi name and power limit, each range's wall, the card's
busy time inside it (the union of its kernels' and copies' intervals),
its kernel launches and copies, launches per env step and per Adam step,
and the ten kernels with the most card time.  ``--trace`` also writes
the Chrome trace.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end_max = 0.0, None
    for start, end in sorted(intervals):
        if end_max is None or start > end_max:
            total += end - start
            end_max = end
        elif end > end_max:
            total += end - end_max
            end_max = end
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--trace", default=None)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("rllib_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke  # noqa: PLC0415
    from ant_ray_tpu_torch.rllib import PPOConfig  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile, record_function

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(**chip_smoke.RLLIB_RUNNERS)
            .training(**chip_smoke.RLLIB_TRAINING).build())
    runner_call, update = algo._runner_call, algo._update
    counts = {"env_steps": 0, "adam_steps": 0}

    def ranged_runner_call(method, *a):
        if method != "sample":
            return runner_call(method, *a)
        with record_function("rllib.sample"):
            out = runner_call(method, *a)
        counts["env_steps"] += sum(f["actions"].size for f in out)
        return out

    def counted_update(*a):
        counts["adam_steps"] += 1
        return update(*a)

    algo.train()                                  # warm-up
    torch.cuda.synchronize()
    algo._runner_call, algo._update = ranged_runner_call, counted_update
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            with record_function("rllib.train"):
                algo.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    samples = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "rllib.sample" and e.device_type == cpu]
    trains = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "rllib.train" and e.device_type == cpu]
    # The card's kernels and copies; the ranges' own mirrors on the
    # card's timeline (user annotations) are not work.
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("rllib.")]

    def within(t, spans):
        return any(a <= t <= b for a, b in spans)

    def stats(spans, exclude=()):
        """Wall of ``spans`` less ``exclude``, and the card's work that
        starts there: each sampling step ends in a card-to-host copy and
        each iteration in reading its metrics, so a range's work has
        ended by the range's end."""
        evs = [e for e in device if within(e.time_range.start, spans)
               and not within(e.time_range.start, exclude)]
        wall = sum(b - a for a, b in spans) - sum(b - a for a, b in exclude)
        busy = _union_us((e.time_range.start, e.time_range.end)
                         for e in evs)
        copies = sum(1 for e in evs if "memcpy" in e.name.lower())
        return {"wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
                "busy_share": busy / wall if wall else None,
                "device_events": len(evs), "copies": copies}

    sample = stats(samples)
    update_stats = stats(trains, exclude=samples)
    runner_steps = counts["env_steps"] // chip_smoke.RLLIB_RUNNERS[
        "num_envs_per_env_runner"]
    by_name = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                           / 1e3, n + 1)
    top = sorted(((name, ms, n) for name, (ms, n) in by_name.items()),
                 key=lambda r: -r[1])[:10]
    print(json.dumps({
        "card": card, "iterations": args.iterations, "wall_s": wall_s,
        "env_steps": counts["env_steps"], "adam_steps": counts["adam_steps"],
        "sample": sample, "update": update_stats,
        "device_events_per_runner_step": sample["device_events"]
        / max(1, runner_steps),
        "device_events_per_adam_step": update_stats["device_events"]
        / max(1, counts["adam_steps"]),
        "top_kernels_ms": [{"name": k, "ms": ms, "count": c}
                           for k, ms, c in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
