"""The knee of an open-loop serving cell: one process, one engine, one
window at each offered rate; not run by the benchmark's own runs.

    python3 -m portbench.sweep --workload <cell> --rates 1.5,2,2.5 \\
        --seconds <s> --seed <n>

For each rate one JSON line: requests due, finished, and still without
a first token at the close; the TTFT median and 90th percentile of the
requests due in the window's first and last thirds (a backlog that
grows shows as a last third far slower than the first); TPOT p90.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import readers, run as bench_run
from portbench.drivers import serve
from portbench.record import Run


def _thirds(run: Run) -> dict:
    out = {}
    third = run.seconds / 3
    for name, lo in (("first", 0.0), ("last", 2 * third)):
        part = Run(cell=run.cell, config=run.config, traffic=run.traffic,
                   seed=run.seed, seconds=run.seconds,
                   window_close=run.window_close,
                   served=[s for s in run.served
                           if lo <= s.due - run.window_start < lo + third])
        t = readers.ttfts(part)
        if t:
            out[f"ttft_p50_ms_{name}"] = 1e3 * float(np.median(t))
            out[f"ttft_p90_ms_{name}"] = 1e3 * readers.p90(t)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg = bench_run.load_json(bench_run.HERE / "configs"
                              / f"{cell['config']}.json")
    tr = bench_run.load_json(bench_run.HERE / "traffic"
                             / f"{cell['traffic']}.json")
    server = None
    for rate in (float(r) for r in args.rates.split(",")):
        run = Run(cell=cell, config=cfg, traffic=dict(tr, rate_per_s=rate),
                  seed=args.seed, seconds=args.seconds)
        if server is None:
            server = serve.Server(run, torch.device("cuda:0"),
                                  time.monotonic())
        else:
            server.fresh_engine(args.seed)
        server.window(run, False, time.monotonic())
        waiting = sum(not any(t <= run.window_close for t in s.token_times)
                      for s in run.served)
        tp = readers.tpots(run)
        print(json.dumps({"rate_per_s": rate, "due": len(run.served),
                          "finished": len(serve.finished(run)),
                          "waiting_at_close": waiting,
                          "tpot_p90_ms": 1e3 * readers.p90(tp) if tp else None,
                          **_thirds(run)}), flush=True)
        server.release_engine()
    return 0


if __name__ == "__main__":
    sys.exit(main())
