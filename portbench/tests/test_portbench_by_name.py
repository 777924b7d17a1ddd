"""A later change adds a configuration, a traffic mix and a metric as
new files and new BENCHMARK.json entries only: the harness finds each by
its name."""

import json
import shutil
import time

from portbench import run as bench_run
from portbench.tests import tiny


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path,
                                                          monkeypatch):
    here = tmp_path / "portbench"
    shutil.copytree(bench_run.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "tiny-mistral.json").write_text(
        json.dumps(tiny.mistral()))
    (here / "traffic" / "tiny.burst.json").write_text(json.dumps(tiny.chat()))
    (here / "layer_metrics" / "requests_seen.tiny.py").write_text(
        '"""Requests due in the window."""\n\n\n'
        "def read(run):\n    return len(run.served)\n")
    bench = tiny.bench()
    bench["configs"].append({"name": "tiny-mistral"})
    cell = {"name": "tiny.burst", "config": "tiny-mistral",
            "traffic": "tiny.burst", "chips": 1}
    bench["workloads"].append(cell)
    first = bench["end_to_end"][0]
    for name in ("requests_seen.tiny", "mfu.tiny"):
        bench["per_layer"].append(
            {"name": name, "unit": "%", "better": "higher",
             "source": "host_clock", "layer": "engine step",
             "moves": first["name"], "workloads": ["tiny.burst"]})
    first["workloads"].append("tiny.burst")
    monkeypatch.setattr(bench_run, "HERE", here)
    run = bench_run.execute(bench, cell, 5, 1.0, True, "cpu",
                            t0=time.monotonic())
    out = bench_run.result(bench, run, True, "cpu")
    assert out["metrics"]["requests_seen.tiny"]["value"] == run.attempted > 0
    # no file of its own: ``mfu.py`` reads it
    assert out["metrics"]["mfu.tiny"]["value"] > 0
    assert out["correct"] is True
    e2e = bench_run.result(bench, run, False, "cpu")["metrics"]
    assert set(e2e) == {first["name"], "setup_s"}
