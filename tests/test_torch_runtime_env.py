"""The port's runtime envs (``_private/runtime_env.py``, the driver's
packaging, the daemon's and the node agent's builds, the workers'
environment) against the JAX package's: the cases of
tests/test_runtime_env.py (validation, py_modules packaged and importable
in workers and nowhere else, content-addressed venvs, pip and uv venvs
whose workers run on the venv's interpreter, slow-marked as there, and
conda's clear error), of tests/test_ops.py (env_vars with pool
isolation, working_dir as the cwd and on the path, an env on an actor,
validation) and tests/test_node_agent.py's delegated build, each run
through both packages with equal outcomes.

One cluster per package for the module, both with the node agent on
(so builds go through the agent, as by default), started with pip and
uv told to use no index: every package a test installs is a wheel made
here."""

from __future__ import annotations

import importlib
import os
import re
import shutil
import textwrap
import time
import zipfile

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
_SETTINGS = {"ART_ENABLE_NODE_AGENT": "1", "PIP_NO_INDEX": "1",
             "PIP_DISABLE_PIP_VERSION_CHECK": "1", "UV_OFFLINE": "1",
             "UV_NO_INDEX": "1"}


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _renv(art):
    return _mod(art, "_private.runtime_env")


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", type(e).__name__, _mask(str(e)))


def _each(scenario):
    got = [scenario(art) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def _agent_info(art, node_address, timeout=30):
    node = _mod(art, "_private.protocol").ClientPool().get(node_address)
    deadline = time.monotonic() + timeout
    info = None
    while time.monotonic() < deadline:
        info = node.call("GetAgentInfo", {}, timeout=5)
        if info["alive"] and info["address"]:
            return info
        time.sleep(0.2)
    raise AssertionError(f"agent never came up: {info}")


@pytest.fixture(scope="module")
def clusters():
    prior = {k: os.environ.get(k) for k in _SETTINGS}
    os.environ.update(_SETTINGS)
    for art in PACKAGES:
        _mod(art, "_private.config")._global_config = None
    try:
        out = {}
        for art in PACKAGES:
            art.init(num_cpus=2)
            out[art] = _mod(art, "_private.worker").global_worker.runtime
        for art in PACKAGES:
            _agent_info(art, out[art].node_address)
        yield out
    finally:
        for art in PACKAGES:
            art.shutdown()
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for art in PACKAGES:
            _mod(art, "_private.config")._global_config = None


def _write_module(path, name, body):
    mod = path / name
    mod.mkdir(parents=True)
    (mod / "__init__.py").write_text(textwrap.dedent(body))
    return str(mod)


def _make_wheel(path) -> str:
    """A minimal pure-python wheel made by hand (a wheel is a zip), so
    the pip path runs with no network."""
    name, version = "artwheel", "0.1"
    whl = path / f"{name}-{version}-py3-none-any.whl"
    info = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", "MAGIC = 777\n")
        zf.writestr(f"{info}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{info}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-"
                    "Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{info}/RECORD", "")
    return str(whl)


# ------------------------------------------- tests/test_runtime_env.py


@pytest.mark.parametrize("env", [
    {"working_dir": ".", "bogus_field": {}},
    {"py_modules": "not-a-list"},
    {"pip": [1, 2]},
    {"pip": {"packages": ["einops"]}},
    {"uv": ["einops"]},
    {"uv": {"packages": ["einops"]}},
    {"conda": "base"},
    {"conda": {"name": "x", "dependencies": ["pip"]}},
    {"conda": {"dependencies": []}},
    {"container": {"image": "img:latest"}},
    {"pip": ["a"], "uv": ["b"]},
    {"conda": 7},
    {"container": {}},
    {"pip": ["requests"]},
    {"docker_image": "x"},
    {"env_vars": {"A": 1}}])
def test_validate_accepts_and_rejects_alike(env):
    """tests/test_runtime_env.py's and tests/test_ops.py's validation
    cases: the same verdict and message from both packages."""
    got = _each(lambda art: _outcome(lambda: _renv(art).validate(env)))
    assert got[0] in ("ok", "raise")


def test_py_modules_package_and_resolve(tmp_path):
    def scenario(art):
        root = tmp_path / art.__name__
        path = _write_module(root, "shiplib", "VALUE = 41\n")
        blobs = {}
        wire = _renv(art).package({"py_modules": [path]},
                                  lambda k, v: blobs.__setitem__(k, v))
        (key,) = wire["py_modules_keys"]
        session = str(root / "session")
        _renv(art).extract(key, blobs[key], session)
        overlay, cwd = _renv(art).resolve(wire, session)
        first = overlay["PYTHONPATH"].split(":")[0]
        return (key in blobs, cwd,
                os.path.exists(os.path.join(first, "shiplib",
                                            "__init__.py")),
                key.startswith("renv:"))

    assert _each(scenario) == (True, None, True, True)


def test_content_addressing(tmp_path):
    """Venvs by requirement set and tool; the wire by content: the same
    module makes the same key in both packages."""
    path = _write_module(tmp_path, "samelib", "X = 1\n")

    def scenario(art):
        renv = _renv(art)
        session = str(tmp_path)
        a = renv.venv_dir(["pkg==1.0"], session)
        keys = []
        renv.package({"py_modules": [path]}, lambda k, v: keys.append(k))
        return (a == renv.venv_dir(["pkg==1.0"], session),
                a != renv.venv_dir(["pkg==2.0"], session),
                renv.venv_dir(["p==1"], session, "uv")
                != renv.venv_dir(["p==1"], session, "pip"),
                os.path.relpath(a, session), keys,
                renv.env_key({"env_vars": {"A": "1"}}), renv.env_key(None))

    _each(scenario)


def test_py_modules_importable_in_workers(clusters, tmp_path):
    def scenario(art):
        path = _write_module(tmp_path / art.__name__, "shipped_mod",
                             """
                             def shipped_value():
                                 return 1234
                             """)

        @art.remote(runtime_env={"py_modules": [path]})
        def use_it():
            import shipped_mod
            return shipped_mod.shipped_value()

        # Without the env the module must NOT leak into other workers.
        @art.remote
        def cannot_see_it():
            try:
                import shipped_mod  # noqa: F401
                return "visible"
            except ImportError:
                return "isolated"

        return (art.get(use_it.remote(), timeout=120),
                art.get(cannot_see_it.remote(), timeout=60))

    assert _each(scenario) == (1234, "isolated")


def _venv_scenario(tool, tmp_path):
    def scenario(art):
        wheel = _make_wheel(tmp_path)

        @art.remote(runtime_env={tool: [wheel]})
        def use_wheel():
            import sys
            import artwheel
            return artwheel.MAGIC, "venvs" in sys.prefix

        @art.remote
        def base_env():
            try:
                import artwheel  # noqa: F401
                return "leaked"
            except ImportError:
                return "isolated"

        return (art.get(use_wheel.remote(), timeout=300),
                art.get(base_env.remote(), timeout=60))

    return scenario


@pytest.mark.slow
def test_pip_venv_workers_run_on_venv_interpreter(clusters, tmp_path):
    assert _each(_venv_scenario("pip", tmp_path)) == ((777, True),
                                                      "isolated")


@pytest.mark.slow
def test_uv_venv_workers_run_on_venv_interpreter(clusters, tmp_path):
    """The uv builder makes the same shape of env as pip (built with pip
    where the uv binary is missing)."""
    assert _each(_venv_scenario("uv", tmp_path)) == ((777, True),
                                                     "isolated")


def test_conda_unavailable_raises_clearly(clusters):
    """Without conda on the node the task fails with an actionable
    message, not a cryptic spawn error."""
    if shutil.which("conda") is not None:
        pytest.skip("conda IS available here; the gated path is moot")

    def scenario(art):
        @art.remote(runtime_env={"conda": "someenv"})
        def f():
            return 1

        with pytest.raises(Exception, match="conda") as ei:
            art.get(f.remote(), timeout=120)
        return type(ei.value).__name__, \
            "requires the conda executable" in str(ei.value)

    assert _each(scenario)[1] is True


# ---------------------------------------------------- tests/test_ops.py


def test_runtime_env_env_vars(clusters):
    def scenario(art):
        @art.remote(runtime_env={"env_vars": {"ART_TEST_FLAG": "banana"}})
        def read_flag():
            return os.environ.get("ART_TEST_FLAG")

        @art.remote
        def read_plain():
            return os.environ.get("ART_TEST_FLAG")

        # Pool isolation: a task without the env never sees the flag.
        return (art.get(read_flag.remote(), timeout=60),
                art.get(read_plain.remote(), timeout=60))

    assert _each(scenario) == ("banana", None)


def test_runtime_env_working_dir(clusters, tmp_path):
    def scenario(art):
        pkg = tmp_path / art.__name__ / "mypkg"
        pkg.mkdir(parents=True)
        (pkg / "helper_mod.py").write_text("VALUE = 'from-working-dir'\n")
        (pkg / "data.txt").write_text("payload")

        @art.remote(runtime_env={"working_dir": str(pkg)})
        def use_working_dir():
            import helper_mod  # found via PYTHONPATH

            with open("data.txt") as f:  # cwd is the staged dir
                data = f.read()
            return helper_mod.VALUE, data

        return art.get(use_working_dir.remote(), timeout=60)

    assert _each(scenario) == ("from-working-dir", "payload")


def test_runtime_env_on_actor(clusters):
    def scenario(art):
        @art.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
        class EnvActor:
            def read(self):
                return os.environ.get("ACTOR_ENV")

        a = EnvActor.remote()
        out = art.get(a.read.remote(), timeout=60)
        art.kill(a)
        return out

    assert _each(scenario) == "yes"


# ---------------------------------------------- tests/test_node_agent.py


def test_agent_builds_runtime_env(clusters, tmp_path):
    """A working_dir env staged through the GCS is extracted BY THE
    AGENT (delegated build), and the task sees the staged files."""
    def scenario(art):
        rt = clusters[art]
        protocol = _mod(art, "_private.protocol")
        info = _agent_info(art, rt.node_address)
        agent = protocol.ClientPool().get(info["address"])
        builds = agent.call("AgentStats", {}, timeout=30)["env_builds"]
        wd = tmp_path / art.__name__ / "agent_wd"
        wd.mkdir(parents=True)
        (wd / "payload.txt").write_text("agent-built")

        @art.remote
        def read_payload():
            with open("payload.txt") as fh:
                return fh.read()

        out = art.get(read_payload.options(
            runtime_env={"working_dir": str(wd)}).remote(), timeout=60)
        stats = agent.call("AgentStats", {}, timeout=30)
        return out, stats["env_builds"] - builds, \
            stats["env_build_failures"] >= 0

    assert _each(scenario) == ("agent-built", 1, True)
