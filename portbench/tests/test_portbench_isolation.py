"""What a run loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``ant_ray_tpu`` (top-level names compared whole: the port's
``ant_ray_tpu_torch`` begins with the JAX package's name); the
references load nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent

RUN_TINY = """
import json, sys, time
from portbench import run as bench_run
from portbench.tests import tiny
run = bench_run.execute(tiny.bench(), tiny.cell("mistral7b.chat", "x", "x"),
                        7, 1.0, False, "cpu", config=tiny.mistral(),
                        traffic=tiny.chat(), t0=time.monotonic())
import portbench.drivers.train, portbench.reference.gpt2
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import portbench.reference.mistral, portbench.reference.gpt2
import portbench.weights, portbench.counts
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _top_level(RUN_TINY)
    assert "ant_ray_tpu_torch" in loaded          # the program ran
    assert not loaded & {"jax", "jaxlib", "flax", "ant_ray_tpu"}


def test_the_references_load_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & {"jax", "jaxlib", "flax", "ant_ray_tpu",
                         "ant_ray_tpu_torch"}


def test_forbidden_names_are_compared_whole():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["ant_ray_tpu_torch", "ant_ray_tpu_torch.llm",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "ant_ray_tpu.models"]) == \
        ["ant_ray_tpu", "jax"]
