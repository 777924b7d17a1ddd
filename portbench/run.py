"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up (import, weights, cache,
warm-up) counts from the process's start; then the cell's driver
measures for ``--seconds``.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the whole window.  The last lines
on standard error are the numbers the output check compared, each with
its limit; the last line on standard output is the result object.

Without a CUDA card (or with fewer than the cell asks for), or if
``jax``, ``jaxlib``, ``flax`` or ``ant_ray_tpu`` is loaded when the
window has closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import os
import time

from portbench.device import process_age_s

T0 = time.monotonic() - process_age_s()
# transformers, if anything imports it, must not load its JAX half
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from portbench import device as dev_info  # noqa: E402
from portbench.record import Run  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ant_ray_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden
    (``ant_ray_tpu_torch`` is not ``ant_ray_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str):
    """The ``read(run)`` of ``<kind>/<name>.py``, or, for a name with a
    dotted suffix (``mfu.chat``) that has no file of its own, of the
    file without the suffix (``mfu.py``)."""
    path = HERE / kind / f"{name}.py"
    while not path.exists() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The end-to-end metrics a cell reports, or (traced) its per-layer
    metrics: those listing the cell, or listing no cells and moving a
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def execute(bench: dict, cell: dict, seed: int, seconds: float,
            traced: bool, device, *, config: dict | None = None,
            traffic: dict | None = None, t0: float | None = None) -> Run:
    """Run a cell through its driver and fill its record.  ``config``
    and ``traffic`` override the files (tests run tiny sizes)."""
    config = config or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic"
                                   / f"{cell['traffic']}.json")
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return driver.run(run, torch.device(device), traced,
                      T0 if t0 is None else t0)


def result(bench: dict, run: Run, traced: bool, device) -> dict:
    metrics = {}
    for m in metrics_of(bench, run.cell["name"], traced):
        kind = "layer_metrics" if traced else "e2e_metrics"
        value = reader(kind, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = torch.device(device)
    out = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(run.cell["chips"]),
            "memory_peak_bytes": int(run.memory_peak_bytes),
        },
    }
    if traced and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_ns / 1e9
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, (value, limit) in run.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    run = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                  "cuda:0")
    out = result(bench, run, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    total = torch.cuda.get_device_properties(0).total_memory
    lines = [f"setup_s {run.setup_s:.4f}: " + ", ".join(
                 f"{k} {v:.4f}" for k, v in run.setup_split.items()),
             *run.notes,
             f"card: {dev_info.power_limit()}; memory peak "
             f"{run.memory_peak_bytes} of {total} bytes "
             f"({100.0 * run.memory_peak_bytes / total:.2f} %)"]
    lines += [f"check {name}: {value!r} limit {limit!r}"
              for name, (value, limit) in run.checks.items()]
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
