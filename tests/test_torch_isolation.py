"""The port stands alone: no module of ``ant_ray_tpu_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package (nor ``safetensors``,
which the card's machine lacks: the port reads the format itself), and
nothing runs on the CPU unless asked to.  Its cluster's processes are
its own: the GCS, the node daemon and the workers run the port's
modules, the daemons never load torch, and ``shutdown()`` leaves none
of them behind."""

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
            "ant_ray_tpu_torch.parallel",
            "ant_ray_tpu_torch.parallel.mesh",
            "ant_ray_tpu_torch.parallel.sharding",
            "ant_ray_tpu_torch.parallel.spmd",
            "ant_ray_tpu_torch.parallel.ring",
            "ant_ray_tpu_torch.parallel.ulysses",
            "ant_ray_tpu_torch.parallel.pipeline",
            "ant_ray_tpu_torch.observability.device_stats",
            "ant_ray_tpu_torch._lint.lockcheck",
            "ant_ray_tpu_torch.exceptions",
            "ant_ray_tpu_torch._private.ids",
            "ant_ray_tpu_torch._private.specs",
            "ant_ray_tpu_torch._private.config",
            "ant_ray_tpu_torch._private.task_options",
            "ant_ray_tpu_torch._private.native",
            "ant_ray_tpu_torch._private.object_store",
            "ant_ray_tpu_torch._private.serialization",
            "ant_ray_tpu_torch.object_ref",
            "ant_ray_tpu_torch._private.worker",
            "ant_ray_tpu_torch.remote_function",
            "ant_ray_tpu_torch.actor",
            "ant_ray_tpu_torch.api",
            "ant_ray_tpu_torch.util.scheduling_strategies",
            "ant_ray_tpu_torch.util.metrics",
            "ant_ray_tpu_torch.util.timeline",
            "ant_ray_tpu_torch.util.tracing",
            "ant_ray_tpu_torch._private.hotframe",
            "ant_ray_tpu_torch._private.wire_schema",
            "ant_ray_tpu_torch._private.protocol",
            "ant_ray_tpu_torch._private.memory_store",
            "ant_ray_tpu_torch.observability.tracing_plane",
            "ant_ray_tpu_torch._private.task_events",
            "ant_ray_tpu_torch._private.task_state",
            "ant_ray_tpu_torch._private.store_client",
            "ant_ray_tpu_torch._private.gcs_client",
            "ant_ray_tpu_torch._private.gcs",
            "ant_ray_tpu_torch._private.transfer",
            "ant_ray_tpu_torch._private.accelerators.gpu",
            "ant_ray_tpu_torch._private.node_daemon",
            "ant_ray_tpu_torch._private.core",
            "ant_ray_tpu_torch._private.worker_main",
            "ant_ray_tpu_torch._private.services",
            "ant_ray_tpu_torch._private.auto_init",
            "ant_ray_tpu_torch.cluster_utils",
            "ant_ray_tpu_torch.observability.cpu_profiler",
            "ant_ray_tpu_torch.util.placement_group",
            "ant_ray_tpu_torch.util.state",
            "ant_ray_tpu_torch._private.log_serving",
            "ant_ray_tpu_torch._private.state_aggregator",
            "ant_ray_tpu_torch._private.node_agent",
            "ant_ray_tpu_torch._private.dashboard",
            "ant_ray_tpu_torch._private.dashboard_ui",
            "ant_ray_tpu_torch.cli",
            "ant_ray_tpu_torch.__main__",
            "ant_ray_tpu_torch._private.runtime_env",
            "ant_ray_tpu_torch._private.export_events",
            "ant_ray_tpu_torch.job_submission",
            "ant_ray_tpu_torch.util.client",
            "ant_ray_tpu_torch.util.client.wire",
            "ant_ray_tpu_torch.util.client.runtime",
            "ant_ray_tpu_torch.util.client.server",
            "ant_ray_tpu_torch._private.store_server",
            "ant_ray_tpu_torch._private.gcs_ha",
            "ant_ray_tpu_torch.ha",
            "ant_ray_tpu_torch.ha.leader_selector",
            "ant_ray_tpu_torch._private.cgroup2",
            "ant_ray_tpu_torch.util.insight",
            "ant_ray_tpu_torch.experimental",
            "ant_ray_tpu_torch.experimental.channel",
            "ant_ray_tpu_torch.dag",
            "ant_ray_tpu_torch.dag.nodes",
            "ant_ray_tpu_torch.dag.compiled",
            "ant_ray_tpu_torch.dag.collective",
            "ant_ray_tpu_torch.util.chaos",
            "ant_ray_tpu_torch.util.actor_pool",
            "ant_ray_tpu_torch.util.queue",
            "ant_ray_tpu_torch.util.virtual_cluster",
            "ant_ray_tpu_torch._lint",
            "ant_ray_tpu_torch._lint.framework",
            "ant_ray_tpu_torch._lint.checkers",
            "ant_ray_tpu_torch._lint.__main__",
            "ant_ray_tpu_torch.tune",
            "ant_ray_tpu_torch.tune.tuner",
            "ant_ray_tpu_torch.tune.trainable",
            "ant_ray_tpu_torch.tune.schedulers",
            "ant_ray_tpu_torch.tune.search",
            "ant_ray_tpu_torch.autoscaler",
            "ant_ray_tpu_torch.autoscaler.autoscaler",
            "ant_ray_tpu_torch.autoscaler.node_provider",
            "ant_ray_tpu_torch._private.sim_node",
            "ant_ray_tpu_torch.util.collective",
            "ant_ray_tpu_torch.util.collective.collective",
            "ant_ray_tpu_torch.util.collective.types",
            "ant_ray_tpu_torch.util.collective.fusion",
            "ant_ray_tpu_torch.util.collective.collective_group",
            "ant_ray_tpu_torch.util.collective.collective_group.base",
            "ant_ray_tpu_torch.util.collective.collective_group.torch_group",
            "ant_ray_tpu_torch.util.collective.collective_group.gloo_group",
            "ant_ray_tpu_torch.util.collective.collective_group.nccl_group",
            "ant_ray_tpu_torch.train",
            "ant_ray_tpu_torch.train.step",
            "ant_ray_tpu_torch.train.config",
            "ant_ray_tpu_torch.train.checkpoint",
            "ant_ray_tpu_torch.train.session",
            "ant_ray_tpu_torch.train.scaling_policy",
            "ant_ray_tpu_torch.train.controller",
            "ant_ray_tpu_torch.train.trainer"} <= set(modules)
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


def test_serializing_a_plain_value_does_not_import_torch():
    """The serialize-side tensor probe looks only at modules already
    loaded: a process that moves plain values never pays torch's import
    (nor does ``import ant_ray_tpu_torch`` itself)."""
    code = (
        "import sys\n"
        "import ant_ray_tpu_torch\n"
        "from ant_ray_tpu_torch._private import serialization as s\n"
        "import numpy as np\n"
        "value = {'a': [1, 'x'], 'b': np.arange(100), 'c': b'y' * 70000}\n"
        "out = s.deserialize(s.SerializedObject.from_payload(\n"
        "    s.serialize(value).to_payload()))\n"
        "assert out['a'] == [1, 'x'] and out['c'] == value['c']\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_tracing_plane_and_the_util_modules_import_no_torch():
    """The GCS and the node daemon load the tracing plane, which reaches
    ``util/metrics.py``; ``util/timeline.py`` and ``util/tracing.py``
    serve a driver that may never touch a tensor.  None of them, nor
    the plane reached through ``ant_ray_tpu_torch.observability``, loads
    torch, JAX or the JAX package, even when used."""
    code = (
        "import sys\n"
        "from ant_ray_tpu_torch.observability import tracing_plane as tp\n"
        "from ant_ray_tpu_torch.observability import TraceContext\n"
        "from ant_ray_tpu_torch.util import metrics, timeline, tracing\n"
        "assert TraceContext is tp.TraceContext\n"
        "metrics.Histogram('h', boundaries=[1.0]).observe(0.5)\n"
        "tp.record_rpc('PushTask', {'execute': 0.1}, 'a' * 32)\n"
        "ctx = tp.mint(sampled=True)\n"
        "with tp.use(ctx), tp.span('s'):\n"
        "    pass\n"
        "spans = tp.recorder().snapshot()\n"
        "trace = timeline.build_chrome_trace([], span_events=spans)\n"
        "assert trace and tracing.export_otlp_json(\n"
        "    spans=tracing.live_spans(spans))['resourceSpans']\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'ant_ray_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_operator_surface_imports_no_torch():
    """The CLI, the dashboard, the state API, placement groups, log
    serving, the node agent and the CPU profiler run in processes that
    never touch a tensor: none loads torch, JAX or the JAX package, even
    when used — the profiler sampling and folding, the CLI parsing and
    diffing two captures, the agent reading the card's memory (through
    NVML, or the CPU entry on a host without a card).  Only the agent's
    trace capture imports torch, when asked for one."""
    code = (
        "import sys, json, tempfile, os, threading, time\n"
        "from ant_ray_tpu_torch import cli\n"
        "from ant_ray_tpu_torch._private import (dashboard, dashboard_ui,\n"
        "    log_serving, node_agent, state_aggregator)\n"
        "from ant_ray_tpu_torch.observability import cpu_profiler\n"
        "from ant_ray_tpu_torch.observability import device_stats\n"
        "from ant_ray_tpu_torch.util import placement_group, state\n"
        "prof = cpu_profiler.CpuProfiler('probe', hz=200.0).start()\n"
        "while prof.overhead_stats()['samples'] < 5:\n"
        "    time.sleep(0.01)\n"
        "prof.stop(final_publish=False)\n"
        "stacks = prof.snapshot()\n"
        "assert cpu_profiler.render_folded(cpu_profiler.merge_folded(\n"
        "    [{'stacks': stacks}]))\n"
        "d = tempfile.mkdtemp()\n"
        "for name in ('a.json', 'b.json'):\n"
        "    json.dump({'stacks': stacks}, open(os.path.join(d, name), 'w'))\n"
        "assert cli.main(['--json', 'profile', '--diff',\n"
        "                 os.path.join(d, 'a.json'),\n"
        "                 os.path.join(d, 'b.json')]) == 0\n"
        "device_stats.device_stats_gauges(device_stats.card_memory_stats())\n"
        "assert 'ant-ray-tpu' in dashboard_ui.INDEX_HTML\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'ant_ray_tpu')),\n"
        "      file=sys.stderr)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "[]"


def test_dag_channels_lockcheck_and_chaos_import_no_torch(tmp_path):
    """The DAG layer, its channels, lockcheck's instrumented locks, the
    chaos harness and the utilities serve processes that may never touch
    a tensor: a plain value through a channel, a compiled graph's specs,
    an instrumented lock's report and a chaos schedule load neither
    torch, JAX nor the JAX package."""
    code = (
        "import sys, threading\n"
        "from ant_ray_tpu_torch import dag\n"
        "from ant_ray_tpu_torch.dag import compiled, collective\n"
        "from ant_ray_tpu_torch.experimental.channel import ShmChannel\n"
        "from ant_ray_tpu_torch._lint import lockcheck\n"
        "from ant_ray_tpu_torch.util import (actor_pool, chaos, queue,\n"
        "    virtual_cluster)\n"
        f"path = {str(tmp_path / 'chan')!r}\n"
        "w = ShmChannel(path, capacity=4096, create=True)\n"
        "r = ShmChannel(path)\n"
        "w.write({'a': [1, 2], 'b': b'x' * 100})\n"
        "assert r.begin_read(timeout=10)['a'] == [1, 2]\n"
        "r.end_read()\n"
        "lockcheck.reset(enabled_override=True)\n"
        "a, b = lockcheck.make_lock('a'), lockcheck.make_lock('b')\n"
        "for x, y in ((a, b), (b, a)):\n"
        "    t = threading.Thread(target=lambda x=x, y=y: [x.acquire(),\n"
        "        y.acquire(), y.release(), x.release()])\n"
        "    t.start(); t.join()\n"
        "assert [r['kind'] for r in lockcheck.reports()] == ['cycle']\n"
        "assert chaos.ChaosSchedule(seed=1).rpc_latency('Ping', 0.1)\\\n"
        "    .system_config() == {'testing_rpc_latency_s': 'Ping:0.1'}\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'ant_ray_tpu')),\n"
        "      file=sys.stderr)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "[]"


def test_train_controller_and_collective_api_import_no_torch():
    """The train plane's driver side (``TorchTrainer``, the controller,
    the configs, checkpoints' handles and retention), the collective
    API's names and the bucket planner load no torch: the controller
    process of a run never touches a tensor.  ``make_optimizer`` and
    ``train_step`` load it on first use."""
    code = (
        "import sys\n"
        "from ant_ray_tpu_torch import train\n"
        "from ant_ray_tpu_torch.train import controller, trainer\n"
        "from ant_ray_tpu_torch.util import collective as col\n"
        "from ant_ray_tpu_torch.util.collective import fusion, types\n"
        "assert train.ScalingConfig(use_gpu=True).worker_resources() == \\\n"
        "    {'GPU': 1.0, 'CPU': 1.0}\n"
        "assert types.Backend.normalize('cuda') == 'nccl'\n"
        "assert col.is_group_initialized('x') is False\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'ant_ray_tpu')),\n"
        "      file=sys.stderr)\n"
        "train.make_optimizer\n"
        "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "[]"


def test_serve_imports_no_torch_and_loads_its_proxies_lazily():
    """The controller, the proxies and the handles run in processes
    that never touch a tensor: ``serve/api.py`` and ``serve/__init__.py``
    load no torch, and aiohttp and grpcio only when a proxy starts."""
    for name in ("api.py", "__init__.py"):
        with open(os.path.join(PKG, "serve", name)) as f:
            tree = ast.parse(f.read())
        imported = {a.name.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
        imported |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert "torch" not in imported, name
    code = (
        "import sys, time\n"
        "import ant_ray_tpu_torch.serve as serve\n"
        "from ant_ray_tpu_torch.serve import api\n"
        "@serve.deployment(name='d', num_replicas=2)\n"
        "class D:\n"
        "    @serve.batch(max_batch_size=2)\n"
        "    def __call__(self, items):\n"
        "        return items\n"
        "app = D.bind()\n"
        "class R:\n"
        "    actor_id = b'r' * 16\n"
        "h = serve.DeploymentHandle('d', [R()])\n"
        "assert h._pick() is not None and app.deployment.num_replicas == 2\n"
        "replica = api.Replica(lambda x: x + 1, (), {})\n"
        "assert replica.handle_request('__call__', (1,), {}) == 2\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {\n"
        "    'torch', 'aiohttp', 'grpc', 'jax', 'ant_ray_tpu'}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_kv_offload_imports_nothing_of_the_jax_package():
    """``llm/kv_offload.py`` reaches the runtime only through the port:
    building both stores, a vault and a slab round trip load neither
    JAX nor the JAX package."""
    code = (
        "import sys, torch\n"
        "from ant_ray_tpu_torch.llm import kv_offload as kvo\n"
        "slab = (torch.ones(2, 3, dtype=torch.bfloat16),\n"
        "        torch.zeros(2, 3), 4)\n"
        "for store in (kvo.LocalKvStore(), kvo.ObjectPlaneKvStore()):\n"
        "    assert store is not None\n"
        "vault = kvo.KvVault()\n"
        "vault.put('k', slab)\n"
        "assert vault.fetch('k') is slab and vault.drop('k')\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ant_ray_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


class _CudaTagged:
    """Pickles exactly as a float32 CUDA tensor of shape (4,) would."""

    def __reduce__(self):
        import pickle

        import numpy as np

        from ant_ray_tpu_torch._private import serialization

        raw = np.arange(4, dtype=np.float32).view(np.uint8)
        return (serialization._rebuild_tensor,
                (pickle.PickleBuffer(raw), "float32", (4,), "cuda"))


def test_cuda_tagged_payload_raises_without_a_card():
    import torch

    from ant_ray_tpu_torch._private import serialization as s

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tensor lands on it")
    payload = s.serialize({"t": _CudaTagged()}).to_payload()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.deserialize(s.SerializedObject.from_payload(payload))


def _children(pid: int) -> list[int]:
    out = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid:
            out.append(int(entry))
    return out


def _cmdline(pid: int) -> str:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


def _maps(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_cluster_processes_are_the_ports_and_shutdown_leaves_none():
    """Every process of a port cluster runs ``ant_ray_tpu_torch`` (a
    missed rename in a ``-m`` string would quietly run the JAX package's
    daemons); the GCS and the node daemon never map libtorch, even after
    a worker returned a tensor through them; a task's worker has neither
    jax nor the JAX package loaded; ``shutdown()`` leaves no process and
    removes the session directory."""
    import time

    import torch

    from ant_ray_tpu_torch._private.worker import global_worker

    ant_ray_tpu_torch.init(num_cpus=2)
    try:
        runtime = global_worker.runtime
        session_dir = runtime.session_dir

        @ant_ray_tpu_torch.remote
        def probe():
            import sys

            return sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "ant_ray_tpu"))

        @ant_ray_tpu_torch.remote
        def tensor():
            import torch

            return torch.arange(6, dtype=torch.bfloat16)

        assert ant_ray_tpu_torch.get([probe.remote() for _ in range(2)]) \
            == [[], []]
        assert torch.equal(ant_ray_tpu_torch.get(tensor.remote()),
                           torch.arange(6, dtype=torch.bfloat16))
        daemons = [p.pid for p in runtime._owned_processes]
        workers = [c for d in daemons for c in _children(d)]
        assert len(daemons) == 2 and workers
        commands = {pid: _cmdline(pid) for pid in daemons + workers}
        modules = sorted(cmd.split(" -m ", 1)[1].split()[0]
                         for cmd in commands.values())
        assert {m for m in modules if not m.endswith("worker_main")} == {
            "ant_ray_tpu_torch._private.gcs",
            "ant_ray_tpu_torch._private.node_daemon"}
        assert all(m.startswith("ant_ray_tpu_torch._private.")
                   for m in modules), modules
        assert not any("ant_ray_tpu._private" in c
                       for c in commands.values())
        for pid in daemons:
            assert "libtorch" not in _maps(pid), commands[pid]
    finally:
        ant_ray_tpu_torch.shutdown()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            _alive(p) for p in daemons + workers):
        time.sleep(0.1)
    assert [p for p in daemons + workers if _alive(p)] == []
    assert not os.path.exists(session_dir)


def test_ha_cgroups_and_insight_import_no_torch(tmp_path):
    """The store server, the HA coordinator and its leader selectors,
    the cgroup manager and flow insight run in control-plane processes:
    none loads torch, JAX or the JAX package, even when used — a store
    server serving a put and a lease, a file lease won, a cgroup subtree
    built on a fake tree, a call graph built."""
    code = (
        "import os, sys\n"
        "from ant_ray_tpu_torch._private import gcs_ha\n"
        "from ant_ray_tpu_torch._private.cgroup2 import CgroupManager\n"
        "from ant_ray_tpu_torch._private.store_client import (\n"
        "    RemoteStoreClient)\n"
        "from ant_ray_tpu_torch._private.store_server import StoreServer\n"
        "from ant_ray_tpu_torch.ha import FileBasedLeaderSelector\n"
        "from ant_ray_tpu_torch.ha.leader_selector import (\n"
        "    StoreBasedLeaderSelector)\n"
        "from ant_ray_tpu_torch.util import insight\n"
        f"tmp = {str(tmp_path)!r}\n"
        "server = StoreServer(os.path.join(tmp, 't.db'))\n"
        "address = server.start()\n"
        "client = RemoteStoreClient('art-store://' + address)\n"
        "client.put('t', 'k', b'v')\n"
        "assert client.get('t', 'k') == b'v'\n"
        "for sel in (StoreBasedLeaderSelector(address),\n"
        "            FileBasedLeaderSelector(os.path.join(tmp, 'lease'))):\n"
        "    sel.start()\n"
        "    assert sel.wait_until_leader(10)\n"
        "    sel.stop()\n"
        "client.close()\n"
        "server.stop()\n"
        "root = os.path.join(tmp, 'cg')\n"
        "os.makedirs(root)\n"
        "open(os.path.join(root, 'cgroup.controllers'), 'w').write('cpu')\n"
        "assert CgroupManager('s', root=root).setup()\n"
        "assert insight.build_call_graph([])['edges'] == []\n"
        "assert gcs_ha.HaCoordinator\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'ant_ray_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_standby_gcs_and_store_server_processes_load_no_torch(tmp_path):
    """A replicated head's GCS processes (leader and standby) and a store
    server process run the port's modules and never map libtorch; the
    cluster's shutdown stops every replica."""
    import time

    from ant_ray_tpu_torch.cluster_utils import Cluster

    store = subprocess.Popen(
        [sys.executable, "-m", "ant_ray_tpu_torch._private.store_server",
         "--path", str(tmp_path / "t.db"), "--monitor-pid",
         str(os.getpid())],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    cluster = Cluster(head_node_args={"num_cpus": 1, "gcs_standbys": 1})
    try:
        line = store.stdout.readline().decode()
        assert line.startswith("STORE_READY "), line
        gcs = [proc.pid for proc, _addr in cluster._gcs_procs]
        assert len(gcs) == 2
        cluster.gcs_leader_address(timeout=30)
        for pid in gcs:
            command = _cmdline(pid)
            assert "-m ant_ray_tpu_torch._private.gcs" in command
            assert "--ha-replica-id" in command
            assert "libtorch" not in _maps(pid), command
        assert "libtorch" not in _maps(store.pid)
    finally:
        cluster.shutdown()
        store.terminate()
        store.wait(timeout=10)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(_alive(p) for p in gcs):
        time.sleep(0.1)
    assert [p for p in gcs if _alive(p)] == []


def test_gpu_detector_imports_no_torch():
    """The daemons detect the cards without torch and without a CUDA
    context: the detector reads files and runs nvidia-smi only."""
    code = (
        "import sys\n"
        "from ant_ray_tpu_torch._private.accelerators import gpu\n"
        "from ant_ray_tpu_torch._private import services\n"
        "n = gpu.num_gpus()\n"
        "res = services.default_resources(2, None, None)\n"
        "assert res.get('GPU', 0.0) == float(n), (res, n)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("mask,physical,visible", [
    ("", 2, 0), ("0", 2, 1), ("1,0", 2, 2), ("0,5,1", 2, 1),
    ("GPU-abc,0", 1, 1), ("-1", 4, 0)])
def test_gpu_detector_honours_cuda_visible_devices(mask, physical, visible,
                                                   monkeypatch):
    from ant_ray_tpu_torch._private.accelerators import gpu

    monkeypatch.setattr(gpu, "_physical_count", lambda: physical)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", mask)
    assert gpu.num_gpus() == visible
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu.num_gpus() == physical
    assert gpu.node_labels() == {}


@pytest.mark.parametrize("runs,want,calls", [
    (["ok"], 2, 1),                        # the first run answers
    (["fail", "timeout", "ok"], 2, 3),     # failed runs are retried
    (["fail", "fail", "fail"], 0, 3),      # three failures read as none
    (["missing"], 0, 1),                   # no nvidia-smi: not retried
])
def test_gpu_detector_retries_a_failed_nvidia_smi(runs, want, calls,
                                                  monkeypatch):
    import subprocess

    from ant_ray_tpu_torch._private.accelerators import gpu

    monkeypatch.setattr(gpu, "_PROC_GPUS", "/nonexistent/nvidia/gpus")
    monkeypatch.setattr(gpu, "_SMI_RETRY_S", 0.0)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    seen = []

    def run(cmd, **_kwargs):
        outcome = runs[len(seen)]
        seen.append(cmd)
        if outcome == "missing":
            raise FileNotFoundError("nvidia-smi")
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, 10.0)
        return subprocess.CompletedProcess(
            cmd, 0 if outcome == "ok" else 9,
            stdout="GPU 0: H100 (UUID: GPU-a)\nGPU 1: H100 (UUID: GPU-b)\n",
            stderr="" if outcome == "ok" else "Unknown Error")

    monkeypatch.setattr(gpu.subprocess, "run", run)
    assert gpu.num_gpus() == want
    assert len(seen) == calls
    assert all(cmd == ["nvidia-smi", "-L"] for cmd in seen)

