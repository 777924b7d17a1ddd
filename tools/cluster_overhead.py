#!/usr/bin/env python3
"""The runtime's own cost per call in cluster mode, the port beside the
JAX package it was ported from, on one host:

    python3 tools/cluster_overhead.py [--calls N] [--rounds R]

Two readings, each of no-op actor calls and no-op tasks through
``.remote()`` + ``get`` beside the same method and function called
directly (medians in µs on the host's clock), with each package's
``hotframe.counters`` read before and after, so that each says how many
of its calls went over hot frames.  Every cluster is
``init(num_cpus=4, num_tpus=0)`` (a GCS, a node daemon and worker
processes) under ``JAX_PLATFORMS=cpu``.

1. Runs in turns, reference, port, port, reference, R times over: each
   a fresh process with one package's cluster, running chip_smoke.py's
   ``runtime_overhead`` probe (N calls of each kind).
2. One process with both packages' clusters up at once, each call of
   one package next to the same call of the other, first one and then
   the other going first (:func:`interleaved_overhead`, N calls of each
   kind), so that both see the same host from one call to the next.

Prints the host's card line (``nvidia-smi``, where there is one), each
run's JSON line, and last one JSON line with every run, per package the
median over its runs of the actor's and the task's cost beyond the
direct call, the interleaved reading, and the port's over the
reference's in each.

The JAX package's cluster mode imports no JAX when ``JAX_PLATFORMS`` is
``cpu``, so this runs where JAX is not installed.  The probe uses no
card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"reference": "ant_ray_tpu", "port": "ant_ray_tpu_torch"}
KINDS = ("actor", "task")
RUN_TIMEOUT_S = 600


class Echo:
    def ping(self, x):
        return x


def echo(x):
    return x


def _hot_counters(art):
    return importlib.import_module(
        f"{art.__name__}._private.hotframe").counters


def interleaved_overhead(arts: tuple, calls: int) -> dict:
    """No-op actor calls and tasks through each initialised package of
    ``arts`` in turn, call by call (the order reversed on every other
    call), after one warm call of each: per
    package the medians beyond the direct call (µs) and the hot-frame
    counts of the timed calls, keyed by package name."""
    plain = Echo()
    direct = {"actor": plain.ping, "task": echo}
    through = {}
    for art in arts:
        # Each package gets its own copy of the function: the two
        # packages' remote wrappers keep state on the function object,
        # and sharing one makes each call re-send its hot-frame template.
        fn = types.FunctionType(echo.__code__, echo.__globals__, "echo")
        actor, task = art.remote(Echo).remote(), art.remote(fn)
        if art.get([actor.ping.remote(-1), task.remote(-1)]) != [-1, -1]:
            raise AssertionError(f"{art.__name__}: warm calls failed")
        through[art] = {
            "actor": lambda i, a=art, h=actor: a.get(h.ping.remote(i)),
            "task": lambda i, a=art, f=task: a.get(f.remote(i))}
    before = {art: dict(_hot_counters(art)) for art in arts}
    times = {(who, kind): [] for who in (*arts, "direct") for kind in KINDS}
    for i in range(calls):
        # Each package goes first on every other call, so that neither
        # always runs in the wake of the other's call.
        turn = arts if i % 2 == 0 else arts[::-1]
        for kind in KINDS:
            for who in (*turn, "direct"):
                call = direct[kind] if who == "direct" else through[who][kind]
                t0 = time.perf_counter_ns()
                out = call(i)
                times[who, kind].append(time.perf_counter_ns() - t0)
                if out != i:
                    raise AssertionError(f"{who} {kind} returned {out!r}")
    median = {key: statistics.median(v) / 1e3 for key, v in times.items()}
    result = {}
    for art in arts:
        counters = _hot_counters(art)
        result[art.__name__] = {
            **{f"{kind}_overhead_us": median[art, kind]
               - median["direct", kind] for kind in KINDS},
            "hotframe": {k: v - before[art][k] for k, v in counters.items()}}
    return result


def _init(package: str):
    art = importlib.import_module(package)
    art.init(num_cpus=4, num_tpus=0)
    return art


def one_run(package: str, calls: int) -> dict:
    """One cluster of ``package``: chip_smoke.py's probe and its
    hot-frame counts."""
    sys.path.insert(0, ROOT)
    import chip_smoke  # noqa: PLC0415

    art = _init(package)
    try:
        before = dict(_hot_counters(art))
        out = chip_smoke.runtime_overhead(art, calls=calls)
        out["hotframe"] = {k: v - before[k]
                           for k, v in _hot_counters(art).items()}
    finally:
        art.shutdown()
    return {"package": package, **out}


def both_run(calls: int) -> dict:
    """Both packages' clusters at once, calls interleaved."""
    arts = []
    try:
        for package in PACKAGES.values():
            arts.append(_init(package))
        return {"package": "both", "calls": calls,
                **interleaved_overhead(tuple(arts), calls)}
    finally:
        for art in reversed(arts):
            art.shutdown()


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out[0] if out else "no card"


def _ratio(port: dict, reference: dict) -> dict:
    return {f"{kind}_overhead_us": port[f"{kind}_overhead_us"]
            / reference[f"{kind}_overhead_us"] for kind in KINDS}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--one", choices=[*PACKAGES.values(), "both"],
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        run = (both_run(args.calls) if args.one == "both"
               else one_run(args.one, args.calls))
        print(json.dumps(run), flush=True)
        return 0

    print(_card(), flush=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    order = ["reference", "port", "port", "reference"] * args.rounds
    runs = []
    for side in [*order, "both"]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             PACKAGES.get(side, side), "--calls", str(args.calls)],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=RUN_TIMEOUT_S, check=False)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], sep="\n",
                  file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append({"side": side, **run})

    summary = {}
    for side in PACKAGES:
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            f"{kind}_overhead_us": statistics.median(
                r[f"{kind}_overhead_us"] for r in mine) for kind in KINDS}
    summary["port_over_reference"] = _ratio(summary["port"],
                                            summary["reference"])
    both = runs[-1]
    summary["interleaved"] = {
        "port_over_reference": _ratio(both[PACKAGES["port"]],
                                      both[PACKAGES["reference"]])}
    print(json.dumps({"calls": args.calls, "runs": runs, **summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
