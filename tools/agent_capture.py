#!/usr/bin/env python3
"""Where the node agent's trace capture (``POST /api/profile`` →
``AgentProfile``) spends its time, step by step, each variant in a fresh
process as the agent would be:

    python3 tools/agent_capture.py [--duration S]

Variants: ``cpu`` (torch.profiler over the CPU only), ``cpu+cuda`` (and
CUDA, as the agent asks for on a host with a card) and ``agent`` (the
agent's own ``NodeAgent._capture_trace``, archive included).  Each
prints one JSON line: seconds to import torch, to detect the cards, to
enter the profiler, the capture window, to leave it, to export the
Chrome trace, and the whole; ``agent`` the whole only.  Prints the
host's nvidia-smi line first where there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STEPS = r"""
import json, os, sys, tempfile, time
t0 = time.perf_counter()
from torch import profiler
t_import = time.perf_counter()
from ant_ray_tpu_torch._private.accelerators import gpu
cards = gpu.num_gpus()
t_detect = time.perf_counter()
activities = [profiler.ProfilerActivity.CPU]
if sys.argv[1] == "cpu+cuda":
    activities.append(profiler.ProfilerActivity.CUDA)
prof = profiler.profile(activities=activities)
prof.__enter__()
t_enter = time.perf_counter()
time.sleep(float(sys.argv[2]))
t_window = time.perf_counter()
prof.__exit__(None, None, None)
t_exit = time.perf_counter()
path = os.path.join(tempfile.mkdtemp(), "trace.json")
prof.export_chrome_trace(path)
t_export = time.perf_counter()
print(json.dumps({"variant": sys.argv[1], "cards": cards,
                  "import_torch_s": round(t_import - t0, 3),
                  "detect_s": round(t_detect - t_import, 3),
                  "enter_s": round(t_enter - t_detect, 3),
                  "window_s": round(t_window - t_enter, 3),
                  "exit_s": round(t_exit - t_window, 3),
                  "export_s": round(t_export - t_exit, 3),
                  "total_s": round(t_export - t0, 3)}))
"""

_AGENT = r"""
import json, sys, tempfile, time
from ant_ray_tpu_torch._private.node_agent import NodeAgent
agent = NodeAgent(tempfile.mkdtemp(), gcs_address="127.0.0.1:1")
t0 = time.perf_counter()
reply = agent._capture_trace(float(sys.argv[2]))
print(json.dumps({"variant": "agent", "error": reply.get("error"),
                  "total_s": round(time.perf_counter() - t0, 3)}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--duration", type=float, default=2.0)
    args = parser.parse_args()
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    except FileNotFoundError:
        print("no nvidia-smi on this host", flush=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    rc = 0
    for variant, code in (("cpu", _STEPS), ("cpu+cuda", _STEPS),
                          ("agent", _AGENT)):
        with tempfile.TemporaryDirectory() as cwd:
            proc = subprocess.run(
                [sys.executable, "-c", code, variant, str(args.duration)],
                capture_output=True, text=True, env=env, cwd=cwd,
                timeout=600)
        line = proc.stdout.strip().splitlines()[-1:] or ["{}"]
        print(line[0] if proc.returncode == 0 else json.dumps(
            {"variant": variant, "rc": proc.returncode,
             "stderr": proc.stderr[-2000:]}), flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
