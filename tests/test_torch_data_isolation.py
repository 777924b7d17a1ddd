"""The port's Data stands alone and runs where the card's machine runs
it: no module of ``ant_ray_tpu_torch.data`` imports torch (the device
feed loads it when a feed starts) or JAX or the JAX package, and
list-block Data — maps, filters, batches, sorts, shuffles, groupbys,
the device feed on the CPU and a streaming split — runs in a cluster
whose driver and workers cannot import pyarrow, while a tabular reader
raises an ``ImportError`` that names pyarrow."""

import ast
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "ant_ray_tpu_torch", "data")


def _run(code, env=None, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_data_modules_import_no_torch_and_the_feed_loads_it_lazily():
    sources = sorted(f for f in os.listdir(DATA) if f.endswith(".py"))
    assert {"block.py", "dataset.py", "device_feed.py", "executor.py",
            "iterator.py"} <= set(sources)
    for name in sources:
        tops = {n.split(".")[0] for n in
                _top_level_imports(os.path.join(DATA, name))}
        assert not tops & {"torch", "jax", "ant_ray_tpu", "pyarrow",
                           "pandas"}, (name, tops)
    out = _run("""
        import json, pkgutil, sys, importlib
        import ant_ray_tpu_torch.data as data
        for m in pkgutil.walk_packages(data.__path__,
                                       prefix="ant_ray_tpu_torch.data."):
            importlib.import_module(m.name)
        before = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("torch", "jax", "ant_ray_tpu", "pyarrow"))
        import ant_ray_tpu_torch as art
        art.init(local_mode=True)
        batches = list(data.range(10).iterator().iter_device_batches(
            batch_size=4, sharding="cpu"))
        art.shutdown()
        print(json.dumps({"before": before,
                          "torch_after": "torch" in sys.modules,
                          "kind": type(batches[0]["value"]).__module__}))
    """)
    assert out == {"before": [], "torch_after": True, "kind": "torch"}


def test_list_block_data_runs_without_pyarrow(tmp_path):
    """``sys.modules["pyarrow"] = None`` in the driver, and a ``pyarrow``
    that fails to import first on the workers' path, as on a host
    without it."""
    stub = tmp_path / "stub" / "pyarrow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text(
        "raise ImportError(\"No module named 'pyarrow'\")\n")
    out = _run(f"""
        import json, sys, threading
        sys.modules["pyarrow"] = None
        import ant_ray_tpu_torch as art
        from ant_ray_tpu_torch import data

        art.init(num_cpus=2)
        out = {{}}
        try:
            out["map"] = sorted(data.range(20, parallelism=4)
                                .map(lambda x: x * 3).take_all())
            out["filter"] = sorted(data.range(20, parallelism=4)
                                   .filter(lambda x: x % 3 == 0).take_all())
            out["flat_map"] = sorted(data.from_items([1, 2, 3])
                                     .flat_map(lambda x: [x] * x).take_all())
            out["map_batches"] = data.range(32, parallelism=2).map_batches(
                lambda b: [sum(b)], batch_size=8).take_all()
            rows = [{{"k": (i * 37) % 101, "g": i % 4}} for i in range(200)]
            out["sort"] = [r["k"] for r in data.from_items(
                rows, parallelism=4).sort("k").take_all()]
            out["random_shuffle"] = data.from_items(
                list(range(100)), parallelism=4).random_shuffle(
                seed=0).take_all()
            out["groupby"] = sorted(
                (r["g"], r["count"]) for r in data.from_items(
                    rows, parallelism=4).groupby("g").count().take_all())
            out["iter_batches"] = [list(b) for b in data.range(
                20, parallelism=3).iter_batches(batch_size=7)]
            out["iter_batches_numpy"] = [b["value"].tolist() for b in
                data.range(10, parallelism=2).iter_batches(
                    batch_size=4, batch_format="numpy")]
            out["device_feed"] = [b["value"].tolist() for b in
                data.range(10, parallelism=2).iterator()
                .iter_device_batches(batch_size=4, sharding="cpu")]
            its = data.range(40, parallelism=4).streaming_split(
                2, equal=True)
            got = [[], []]

            def consume(i):
                for batch in its[i].iter_batches(batch_size=8,
                                                 batch_format="rows"):
                    got[i].extend(batch)

            threads = [threading.Thread(target=consume, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            out["streaming_split"] = [sorted(g) for g in got]
            try:
                data.read_parquet({str(tmp_path)!r})
                out["read_parquet"] = "no error"
            except ImportError as e:
                out["read_parquet"] = str(e)
        finally:
            art.shutdown()
        out["pyarrow_loaded"] = sys.modules.get("pyarrow") is not None
        print(json.dumps(out))
    """, env={"PYTHONPATH": os.pathsep.join([str(tmp_path / "stub"),
                                             REPO])})
    rows = [{"k": (i * 37) % 101, "g": i % 4} for i in range(200)]
    assert out["map"] == [3 * x for x in range(20)]
    assert out["filter"] == [x for x in range(20) if x % 3 == 0]
    assert out["flat_map"] == [1, 2, 2, 3, 3, 3]
    assert out["map_batches"] == [sum(range(i, i + 8))
                                  for i in range(0, 32, 8)]
    assert out["sort"] == sorted(r["k"] for r in rows)
    assert sorted(out["random_shuffle"]) == list(range(100))
    assert out["random_shuffle"] != list(range(100))
    assert out["groupby"] == [[g, 50] for g in range(4)]
    assert out["iter_batches"] == [list(range(i, min(i + 7, 20)))
                                   for i in range(0, 20, 7)]
    assert out["iter_batches_numpy"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert out["device_feed"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 0]]
    a, b = out["streaming_split"]
    assert len(a) == len(b) == 20 and sorted(a + b) == list(range(40))
    assert "pyarrow" in out["read_parquet"]
    assert out["pyarrow_loaded"] is False
