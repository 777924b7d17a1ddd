"""Readings that the output check's limits are set from, and the
control that must fail them; not run by the benchmark's own runs.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --seconds <s> [--fault <name>] [--out <file.jsonl>]
    python3 -m portbench.calibrate --config gpt2-xl --traffic gpt2xl.train \\
        --seeds 1,2 [--control] [--out <file.jsonl>]

For a serving cell one process builds the program once and, for each
seed, makes that seed's weights, a fresh engine, and one window of the
cell's traffic at the cell's load; then the family's fp32 reference
reads the sample a run would compare (``logit_gap_max``), and the fp8
control the same positions (``control_logit_gap_max``).  One JSON line
a seed.  With ``--fault`` (``portbench/faults.py``: ``state_unchanged``,
``half_batch``, ``token_altered``) the fault is planted under the
program first, and the line gives what the check reads of it, without
the control.

For a training configuration, each seed builds the program's training
object (its first steps are the readings), frees it, and runs the fp32
reference over the same steps; ``--control`` adds the fp8 reference
and the half-batch fault, each read against the fp32 reference.  The
line gives the three gaps and the worst leaves.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, run as bench_run
from portbench.drivers import serve, train
from portbench.record import Run


def serve_readings(bench, cell, seeds, seconds, device, out, fault=None):
    cfg = bench_run.load_json(bench_run.HERE / "configs"
                              / f"{cell['config']}.json")
    tr = bench_run.load_json(bench_run.HERE / "traffic"
                             / f"{cell['traffic']}.json")
    server = None
    for seed in seeds:
        run = Run(cell=cell, config=cfg, traffic=tr, seed=seed,
                  seconds=seconds)
        t0 = time.monotonic()
        if server is None:
            server = serve.Server(run, device, t0)
        else:
            server.reseed(seed)
            server.fresh_engine(seed)
        prompts = server.window(run, False, time.monotonic())
        server.release_engine()
        t1 = time.monotonic()
        serve.check(run, server.weights, prompts, control=fault is None)
        line = {"cell": cell["name"], "seed": seed, "fault": fault,
                "finished": len(serve.finished(run)),
                "attempted": run.attempted, "failed": run.failed,
                "sampled_tokens": sum(len(s.tokens) for s in serve.sample(
                    run, serve.finished(run))),
                "check_s": time.monotonic() - t1,
                **{k: v for k, (v, _) in run.checks.items()},
                "notes": run.notes}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")


def train_readings(cell, cfg, tr, seeds, device, out, control):
    for seed in seeds:
        run = Run(cell=cell, config=cfg, traffic=tr, seed=seed, seconds=0.0)
        mark = time.monotonic()
        trainer = train.Trainer(run, device, mark)
        prog = trainer.readings
        trainer.release()
        ref = train.reference_readings(run, device)
        line = {"config": cfg["name"], "dtype": cfg["torch_dtype"],
                "seed": seed, "s": time.monotonic() - mark,
                "losses": prog["losses"], "ref_losses": ref["losses"],
                **{k: v for k, (v, _) in train.gaps(prog, ref).items()}}
        worst = sorted(train.leaf_gaps(prog, ref).items(),
                       key=lambda kv: -kv[1][1])[:5]
        line["worst_change_leaves"] = [[n, g, c, prog["change_norms"][n],
                                        ref["change_norms"][n]]
                                       for n, (g, c) in worst]
        if control:
            for name, kw in (("control", {"control": True}),
                             ("half_batch", {"half_batch": True})):
                other = train.reference_readings(run, device, **kw)
                line[name] = {k: v for k, (v, _) in
                              train.gaps(other, ref).items()}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda:0")
    if args.workload:
        bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
        cell = next(c for c in bench["workloads"]
                    if c["name"] == args.workload)
        if args.fault:
            faults.plant(args.fault)
        serve_readings(bench, cell, seeds, args.seconds, device, args.out,
                       args.fault)
        return 0
    cfg = bench_run.load_json(bench_run.HERE / "configs"
                              / f"{args.config}.json")
    tr = bench_run.load_json(bench_run.HERE / "traffic"
                             / f"{args.traffic}.json")
    cell = {"name": args.traffic, "config": args.config,
            "traffic": args.traffic, "chips": 1}
    train_readings(cell, cfg, tr, seeds, device, args.out, args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
