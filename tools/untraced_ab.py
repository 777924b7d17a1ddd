#!/usr/bin/env python3
"""The untraced serving path of several checkouts, in turns, on one
NVIDIA GPU: an ``LLMServer`` on Llama-3-8B (random weights from seed 0,
slots=2, max_seq=4096, bucketed prefill, ``kv_offload="local"``) in
this process, no trace context anywhere.

    python3 tools/untraced_ab.py [--rounds R] CHECKOUT [CHECKOUT ...]

Runs each checkout in a process of its own (with that checkout first on
``sys.path``), in the order given and then reversed (A, B, B, A for
two), R times (default 1), and prints one JSON line per run, then one
with every run's medians side by side.  A run times, after two warm-up
requests, 10 completions of 1500 token ids with 16 new tokens (host
wall of ``server(request)``) and 10 streams of the same prompt (time to
the first chunk and to the last), medians in ms, and checks that every
completion's tokens equal the first's.

To compare two commits, unpack one with ``git archive <commit> | tar -x
-C <dir>`` into a directory that ``.gitignore`` lists and pass both.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REQUESTS = 10
PROMPT_TOKENS = 1500
NEW_TOKENS = 16


def one(checkout: str) -> dict:
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from ant_ray_tpu_torch.llm import LLMServer
    from ant_ray_tpu_torch.models import llama
    from ant_ray_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("untraced_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = llama.CONFIGS["llama3-8b"]
    prompt = np.random.default_rng(16).integers(
        0, cfg.vocab_size, PROMPT_TOKENS).tolist()
    request = {"prompt": prompt, "max_tokens": NEW_TOKENS}
    server = LLMServer("llama3-8b", slots=2, max_seq=4096, seed=0,
                       prefill_chunk_tokens=None, kv_offload="local")
    try:
        want = server(request)["choices"][0]["token_ids"]
        list(server.stream(request))
        complete, first, last, equal = [], [], [], True
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            got = server(request)["choices"][0]["token_ids"]
            complete.append(time.perf_counter() - t0)
            equal = equal and got == want
            t0 = time.perf_counter()
            stamps = [time.perf_counter() - t0
                      for _ in server.stream(request)]
            first.append(stamps[0])
            last.append(stamps[-1])
    finally:
        server.shutdown()
    return {"checkout": checkout, "tokens_equal": equal,
            "completion_ms": statistics.median(complete) * 1e3,
            "stream_first_ms": statistics.median(first) * 1e3,
            "stream_last_ms": statistics.median(last) * 1e3,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    args = sys.argv[1:]
    rounds = 1
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    checkouts = [os.path.abspath(c) for c in args]
    if not checkouts:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for checkout in (checkouts + checkouts[::-1]) * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", checkout],
            cwd=checkout, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=checkout))
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "by_checkout": {
        c: [{k: r[k] for k in ("completion_ms", "stream_first_ms",
                               "stream_last_ms", "tokens_equal")}
            for r in runs if r["checkout"] == c] for c in checkouts}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
