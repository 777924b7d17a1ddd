"""The port stands alone: no module of ``ant_ray_tpu_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package (nor ``safetensors``,
which the card's machine lacks: the port reads the format itself), and
nothing runs on the CPU unless asked to."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import ant_ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ant_ray_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ant_ray_tpu", "flax", "optax", "orbax",
             "safetensors")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ant_ray_tpu_torch.__path__, prefix="ant_ray_tpu_torch."))


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_neither_jax_nor_the_jax_package():
    modules = _port_modules()
    assert {"ant_ray_tpu_torch.llm.engine", "ant_ray_tpu_torch.llm.serve_llm",
            "ant_ray_tpu_torch.llm.chat", "ant_ray_tpu_torch.serve.api",
            "ant_ray_tpu_torch.models.checkpoint",
            "ant_ray_tpu_torch.models.gpt2",
            "ant_ray_tpu_torch.observability.device_stats"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ant_ray_tpu',\n"
        "                                    'safetensors'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert os.path.join(REPO, "chip_smoke.py") in sources
    offenders = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}: {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_engine_without_device_raises_instead_of_running_on_cpu():
    import torch

    from ant_ray_tpu_torch.llm import LLMEngine
    from ant_ray_tpu_torch.models import llama

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine("tiny")
    with pytest.raises(RuntimeError):
        llama.init_params(llama.CONFIGS["tiny"])
    with pytest.raises(RuntimeError):
        llama.init_kv_cache(llama.CONFIGS["tiny"], 1)
