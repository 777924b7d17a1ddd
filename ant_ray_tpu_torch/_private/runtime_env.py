"""Runtime environments: per-task/actor env_vars, working_dir,
py_modules and pip venvs (ref: python/ray/_private/runtime_env/ — the
plugin architecture reduced to its load-bearing plugins; URI-cached
packages live in GCS KV exactly like the reference caches working_dir
zips in the GCS' internal KV, ref: runtime_env/working_dir.py,
py_modules.py, pip.py).

Wire form (what travels in TaskSpec/ActorSpec/lease payloads):
    {"env_vars": {...}, "working_dir_key": "renv:<sha256-16>",
     "py_modules_keys": ["renv:<sha>", ...], "pip": ["pkg==1.2", ...]}

``pip`` builds one node-local venv per requirement set (content
addressed, ``--system-site-packages`` so the framework and torch stay
importable) and workers of that env run on the venv's interpreter —
the reference's pip plugin semantics (runtime_env/pip.py) without
per-worker virtualenv duplication.  A venv worker imports this package
from the same checkout as every other process, so the CUDA kernels it
loads are the libraries already built in ``ant_ray_tpu_torch/_build/``:
their names hash the sources and nvcc's flags, never the interpreter.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import zipfile

logger = logging.getLogger(__name__)

MAX_WORKING_DIR_BYTES = 100 * 1024 * 1024


def _package_list(field: str, value) -> list:
    if isinstance(value, dict):
        value = value.get("packages")
    if not (isinstance(value, (list, tuple))
            and all(isinstance(p, str) for p in value)):
        raise ValueError(
            f"runtime_env {field} must be a list of requirement "
            "strings or {'packages': [...]}")
    return list(value)


def validate(runtime_env: dict) -> None:
    unknown = set(runtime_env) - {"env_vars", "working_dir",
                                  "py_modules", "pip", "uv", "conda",
                                  "container"}
    if unknown:
        raise ValueError(
            f"unsupported runtime_env field(s) {sorted(unknown)}; "
            "supported: env_vars, working_dir, py_modules, pip, uv, "
            "conda, container")
    exclusive = [f for f in ("pip", "uv", "conda", "container")
                 if runtime_env.get(f)]
    if len(exclusive) > 1:
        raise ValueError(
            f"runtime_env fields {exclusive} are mutually exclusive — "
            "a worker runs in exactly one python environment")
    if runtime_env.get("uv") is not None:
        _package_list("uv", runtime_env["uv"])
    conda = runtime_env.get("conda")
    if conda is not None:
        if not isinstance(conda, (str, dict)):
            raise ValueError(
                "runtime_env conda must be an existing env name (str) "
                "or an environment.yml dict")
        if isinstance(conda, dict) and not conda.get("name"):
            raise ValueError(
                "runtime_env conda yaml dicts need a 'name' field")
    container = runtime_env.get("container")
    if container is not None and not (
            isinstance(container, dict) and container.get("image")):
        raise ValueError(
            "runtime_env container must be {'image': <image>, ...}")
    env_vars = runtime_env.get("env_vars") or {}
    if not all(isinstance(k, str) and isinstance(v, str)
               for k, v in env_vars.items()):
        raise ValueError("runtime_env env_vars must be str->str")
    py_modules = runtime_env.get("py_modules") or []
    if not isinstance(py_modules, (list, tuple)) or not all(
            isinstance(p, (str, os.PathLike)) for p in py_modules):
        raise ValueError(
            "runtime_env py_modules must be a list of path strings "
            "(or PathLike)")
    pip = runtime_env.get("pip")
    if pip is not None:
        if isinstance(pip, dict):
            pip = pip.get("packages")
        if not (isinstance(pip, (list, tuple))
                and all(isinstance(p, str) for p in pip)):
            raise ValueError(
                "runtime_env pip must be a list of requirement strings "
                "or {'packages': [...]}")


def _zip_dir(path: str, prefix: str = "") -> bytes:
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(path):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.join(prefix, os.path.relpath(full, path))
                total += os.path.getsize(full)
                if total > MAX_WORKING_DIR_BYTES:
                    raise ValueError(
                        f"package {path!r} exceeds "
                        f"{MAX_WORKING_DIR_BYTES >> 20} MiB")
                zf.write(full, rel)
    return buf.getvalue()


def ensure_framework_on_pythonpath(env: dict) -> None:
    """Make child processes able to import a checkout-run framework even
    after a cwd change (shared by worker spawn and job drivers)."""
    import ant_ray_tpu_torch  # noqa: PLC0415

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ant_ray_tpu_torch.__file__)))
    existing = env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(":"):
        env["PYTHONPATH"] = (f"{existing}:{pkg_root}" if existing
                             else pkg_root)


def _dir_entries(path: str) -> list:
    entries = []
    for root, _dirs, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            try:
                st = os.stat(full)
                entries.append((os.path.relpath(full, path),
                                st.st_size, st.st_mtime_ns))
            except OSError:
                entries.append((os.path.relpath(full, path), -1, -1))
    return sorted(entries)


def content_fingerprint(runtime_env: dict) -> str:
    """Cache identity covering EVERY field that affects the wire form
    (env_vars, working_dir and py_modules contents — path, size, mtime
    per file — and the pip list), so edits re-package instead of
    silently reusing a stale wire and two different envs can never
    collide on an empty fingerprint."""
    parts = [repr(sorted((runtime_env.get("env_vars") or {}).items()))]
    working_dir = runtime_env.get("working_dir")
    if working_dir:
        parts.append("wd:" + working_dir)
        parts.append(repr(_dir_entries(working_dir)))
    for mod_path in runtime_env.get("py_modules") or ():
        mod_path = os.fspath(mod_path)
        parts.append("mod:" + mod_path)
        if os.path.isdir(mod_path):
            parts.append(repr(_dir_entries(mod_path)))
        else:
            try:
                st = os.stat(mod_path)
                parts.append(repr((st.st_size, st.st_mtime_ns)))
            except OSError:
                parts.append("missing")
    pip = runtime_env.get("pip")
    if pip:
        if isinstance(pip, dict):
            pip = pip.get("packages") or []
        parts.append("pip:" + repr(sorted(pip)))
    uv = runtime_env.get("uv")
    if uv:
        if isinstance(uv, dict):
            uv = uv.get("packages") or []
        parts.append("uv:" + repr(sorted(uv)))
    if runtime_env.get("conda"):
        parts.append("conda:" + json.dumps(runtime_env["conda"],
                                           sort_keys=True))
    if runtime_env.get("container"):
        parts.append("container:" + json.dumps(runtime_env["container"],
                                               sort_keys=True))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _zip_module(path: str) -> bytes:
    """Package one py_module: a directory (kept under its basename, so
    extraction + PYTHONPATH makes ``import <basename>`` work) or a
    single ``.py`` file.  Same size cap as working_dir."""
    if os.path.isdir(path):
        return _zip_dir(path,
                        prefix=os.path.basename(os.path.normpath(path)))
    if os.path.isfile(path) and path.endswith(".py"):
        if os.path.getsize(path) > MAX_WORKING_DIR_BYTES:
            raise ValueError(f"py_module {path!r} exceeds "
                             f"{MAX_WORKING_DIR_BYTES >> 20} MiB")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.write(path, os.path.basename(path))
        return buf.getvalue()
    raise ValueError(f"py_module {path!r} is neither a package "
                     "directory nor a .py file")


def package(runtime_env: dict | None, kv_put) -> dict | None:
    """Driver side: validate and stage into GCS KV; returns wire form.

    ``kv_put(key, value_bytes)`` uploads content-addressed blobs."""
    if not runtime_env:
        return None
    validate(runtime_env)
    wire: dict = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        wire["env_vars"] = dict(env_vars)
    working_dir = runtime_env.get("working_dir")
    if working_dir:
        if not os.path.isdir(working_dir):
            raise ValueError(f"working_dir {working_dir!r} is not a "
                             "directory")
        blob = _zip_dir(working_dir)
        key = f"renv:{hashlib.sha256(blob).hexdigest()[:16]}"
        kv_put(key, blob)
        wire["working_dir_key"] = key
    keys = []
    for mod_path in runtime_env.get("py_modules") or ():
        blob = _zip_module(os.fspath(mod_path))
        key = f"renv:{hashlib.sha256(blob).hexdigest()[:16]}"
        kv_put(key, blob)
        keys.append(key)
    if keys:
        wire["py_modules_keys"] = keys
    pip = runtime_env.get("pip")
    if pip:
        if isinstance(pip, dict):
            pip = pip.get("packages")
        wire["pip"] = sorted(pip)
    uv = runtime_env.get("uv")
    if uv:
        wire["uv"] = sorted(_package_list("uv", uv))
    if runtime_env.get("conda"):
        wire["conda"] = runtime_env["conda"]
    if runtime_env.get("container"):
        wire["container"] = dict(runtime_env["container"])
    return wire or None


def env_key(wire: dict | None) -> str:
    """Stable identity for worker-pool matching: workers are only
    reused for tasks with the same runtime env."""
    if not wire:
        return ""
    return json.dumps(wire, sort_keys=True)


def package_dir(key: str, session_dir: str) -> str:
    return os.path.join(session_dir, "runtime_envs", key.split(":", 1)[1])


def is_extracted(key: str, session_dir: str) -> bool:
    return os.path.exists(os.path.join(package_dir(key, session_dir),
                                       ".art_ready"))


def extract(key: str, blob: bytes, session_dir: str) -> str:
    """Idempotent, race-safe zip extraction; returns the package dir."""
    target = package_dir(key, session_dir)
    if is_extracted(key, session_dir):
        return target
    tmp = target + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    open(os.path.join(tmp, ".art_ready"), "w").close()
    try:
        os.rename(tmp, target)
    except OSError:
        # lost the race to another extractor — use theirs
        import shutil  # noqa: PLC0415

        shutil.rmtree(tmp, ignore_errors=True)
    return target


def resolve(wire: dict | None, session_dir: str) -> tuple[dict, str | None]:
    """(env_overlay, cwd) for a wire env whose packages are already
    extracted (see ``extract``); pure path/dict logic, safe to call on
    an event loop."""
    if not wire:
        return {}, None
    overlay = dict(wire.get("env_vars") or {})
    cwd = None
    paths = []
    key = wire.get("working_dir_key")
    if key:
        if not is_extracted(key, session_dir):
            raise RuntimeError(
                f"runtime_env package {key} not extracted — prefetch it "
                "before spawning")
        cwd = package_dir(key, session_dir)
        # The reference puts working_dir on sys.path of the worker.
        paths.append(cwd)
    for mkey in wire.get("py_modules_keys") or ():
        if not is_extracted(mkey, session_dir):
            raise RuntimeError(
                f"runtime_env package {mkey} not extracted — prefetch "
                "it before spawning")
        paths.append(package_dir(mkey, session_dir))
    if paths:
        existing = overlay.get("PYTHONPATH", os.environ.get(
            "PYTHONPATH", ""))
        joined = ":".join(paths)
        overlay["PYTHONPATH"] = (f"{joined}:{existing}" if existing
                                 else joined)
    venv = None
    if wire.get("pip"):
        venv = venv_dir(wire["pip"], session_dir, "pip")
    elif wire.get("uv"):
        venv = venv_dir(wire["uv"], session_dir, "uv")
    if venv:
        overlay["VIRTUAL_ENV"] = venv
        overlay["PATH"] = (f"{venv}/bin:"
                           + overlay.get("PATH", os.environ.get("PATH", "")))
    return overlay, cwd


# ------------------------------------------------------------------ pip

import threading as _threading

_venv_build_locks: dict = {}
_venv_build_locks_guard = _threading.Lock()


def venv_dir(pip: list, session_dir: str, tool: str = "pip") -> str:
    ident = hashlib.sha256(
        json.dumps([tool, sorted(pip)]).encode()).hexdigest()[:16]
    return os.path.join(session_dir, "venvs", ident)


def conda_env_name(conda) -> str:
    """The node-side env name: user-named envs as given; yaml envs get
    a content-hash suffix so changed dependencies under the same name
    rebuild instead of silently reusing the stale env (the same
    content-addressing venv_dir gives pip/uv)."""
    if isinstance(conda, str):
        return conda
    digest = hashlib.sha256(
        json.dumps(conda, sort_keys=True).encode()).hexdigest()[:8]
    return f"{conda['name']}-art{digest}"


# env name -> resolved interpreter path; populated by ensure_env_ready
# on an executor thread so the spawn path never blocks the event loop
# on a `conda run` subprocess.
_conda_python_cache: dict = {}


def _conda_exe() -> str:
    """The node's conda executable — the single place the
    conda-not-installed error comes from."""
    import shutil  # noqa: PLC0415

    exe = shutil.which("conda")
    if exe is None:
        raise RuntimeError(
            "runtime_env conda requires the conda executable on the "
            "node; it is not installed here (use pip/uv runtime envs, "
            "or install miniconda on every node)")
    return exe


def conda_python(conda) -> str:
    """Interpreter of an EXISTING conda env (ref: runtime_env/conda.py
    — named envs resolve to their prefix; yaml envs are created by
    ensure_env_ready)."""
    import subprocess  # noqa: PLC0415

    name = conda_env_name(conda)
    cached = _conda_python_cache.get(name)
    if cached is not None:
        return cached
    exe = _conda_exe()
    proc = subprocess.run(
        [exe, "run", "-n", name, "python", "-c",
         "import sys; print(sys.executable)"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(
            f"conda env {name!r} is not usable:\n{proc.stderr[-1000:]}")
    path = proc.stdout.strip()
    _conda_python_cache[name] = path
    return path


def venv_python(wire: dict | None, session_dir: str) -> str | None:
    """Interpreter for the env's isolated python, or None when the env
    uses the parent interpreter."""
    wire = wire or {}
    if wire.get("pip"):
        return os.path.join(venv_dir(wire["pip"], session_dir),
                            "bin", "python")
    if wire.get("uv"):
        return os.path.join(venv_dir(wire["uv"], session_dir, "uv"),
                            "bin", "python")
    if wire.get("conda"):
        return conda_python(wire["conda"])
    return None


import contextlib as _contextlib


@_contextlib.contextmanager
def _disk_build_lock(session_dir: str, tag: str):
    """Cross-PROCESS build serialization: the daemon's in-process
    fallback and the node agent can race to build the same env (the
    agent comes up mid-build); an flock on a session-local lockfile
    makes the loser wait and then see the winner's ready marker.
    In-process threads are already serialized by _venv_build_locks."""
    import fcntl  # noqa: PLC0415

    locks_dir = os.path.join(session_dir, ".build_locks")
    os.makedirs(locks_dir, exist_ok=True)
    with open(os.path.join(locks_dir, tag), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def is_ready(wire: dict | None, session_dir: str) -> bool:
    """Cheap LOCAL readiness probe — the daemon's fast path: when
    everything is already materialized, worker spawn skips both the
    agent RPC and the executor hop."""
    wire = wire or {}
    keys = ([wire["working_dir_key"]] if wire.get("working_dir_key")
            else []) + list(wire.get("py_modules_keys") or ())
    if any(not is_extracted(k, session_dir) for k in keys):
        return False
    if wire.get("pip"):
        return os.path.exists(os.path.join(
            venv_dir(wire["pip"], session_dir, "pip"), ".art_ready"))
    if wire.get("uv"):
        return os.path.exists(os.path.join(
            venv_dir(wire["uv"], session_dir, "uv"), ".art_ready"))
    if wire.get("conda"):
        try:
            return conda_env_name(wire["conda"]) in _conda_python_cache
        except Exception:  # noqa: BLE001 — malformed spec: not ready
            return False
    if wire.get("container"):
        return False      # containers are gated node-side every time
    return True


async def materialize(wire: dict | None, session_dir: str,
                      kv_get) -> None:
    """The ONE build sequence (the node agent and the daemon's
    in-process fallback both run exactly this): fetch + extract staged
    packages via ``await kv_get(key)``, then build the interpreter
    layer (pip/uv/conda/container) off the event loop."""
    import asyncio  # noqa: PLC0415

    wire = wire or {}
    keys = ([wire["working_dir_key"]] if wire.get("working_dir_key")
            else []) + list(wire.get("py_modules_keys") or ())
    for key in keys:
        if is_extracted(key, session_dir):
            continue
        blob = await kv_get(key)
        if blob is None:
            raise RuntimeError(
                f"runtime_env package {key} missing from GCS KV")
        extract(key, blob, session_dir)
    if any(wire.get(f) for f in ("pip", "uv", "conda", "container")):
        # Env materialization is slow (subprocess pip/uv/conda) — off
        # the event loop.
        await asyncio.get_running_loop().run_in_executor(
            None, ensure_env_ready, wire, session_dir)


def ensure_venv(pip: list, session_dir: str, tool: str = "pip") -> str:
    """Build (once) the content-addressed venv for a requirement set.

    ``--system-site-packages`` keeps the framework + torch importable from
    the parent environment; pip/uv only layer the requested packages on
    top (ref: runtime_env/pip.py + runtime_env/uv.py build exactly this
    shape of env).  Blocking — call from a thread, not the event loop.
    """
    target = venv_dir(pip, session_dir, tool)
    ready = os.path.join(target, ".art_ready")
    if os.path.exists(ready):
        return target
    # One build per requirement set per process (concurrent leases land
    # on executor threads that share a pid); _build_venv's uuid suffix
    # keeps cross-process builders off each other's tmp dirs.
    with _venv_build_locks_guard:
        lock = _venv_build_locks.setdefault(target, _threading.Lock())
    with lock:
        if os.path.exists(ready):
            return target
        with _disk_build_lock(session_dir, os.path.basename(target)):
            if os.path.exists(ready):   # another PROCESS built it
                return target
            return _build_venv(pip, target, tool)


def ensure_env_ready(wire: dict, session_dir: str) -> None:
    """Materialize the env's interpreter layer (the slow part the
    daemon prefetches off its event loop): pip/uv venv build, conda
    yaml creation, container gating."""
    import shutil  # noqa: PLC0415
    import subprocess  # noqa: PLC0415

    if wire.get("pip"):
        ensure_venv(wire["pip"], session_dir, "pip")
    elif wire.get("uv"):
        ensure_venv(wire["uv"], session_dir, "uv")
    elif wire.get("conda"):
        conda = wire["conda"]
        if isinstance(conda, dict):
            exe = _conda_exe()
            name = conda_env_name(conda)
            with _disk_build_lock(session_dir, f"conda_{name}"):
                # artlint: disable=blocking-under-lock — serializing
                # the conda build across processes IS the disk lock's
                # purpose; this runs on the daemon's env executor
                # thread, never on the event loop.
                probe = subprocess.run(
                    [exe, "env", "list"], capture_output=True, text=True,
                    timeout=120)
                existing = set()
                for line in probe.stdout.splitlines():
                    if line and not line.startswith("#"):
                        first = line.split()[0]
                        existing.add(os.path.basename(first))
                if name not in existing:
                    spec = dict(conda, name=name)
                    spec_path = os.path.join(session_dir,
                                             f"conda_{name}.yml")
                    import yaml as _yaml  # noqa: PLC0415

                    with open(spec_path, "w") as f:
                        _yaml.safe_dump(spec, f)
                    # artlint: disable=blocking-under-lock — same
                    # deliberate build serialization as the probe above.
                    proc = subprocess.run(
                        [exe, "env", "create", "-f", spec_path],
                        capture_output=True, text=True, timeout=1800)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"conda env create failed:"
                            f"\n{proc.stderr[-2000:]}")
        conda_python(conda)   # resolve + CACHE now (executor thread),
        #                       so the spawn path is pure dict lookup
    elif wire.get("container"):
        if shutil.which("podman") is None and \
                shutil.which("docker") is None:
            raise RuntimeError(
                "runtime_env container requires podman or docker on "
                "the node; neither is installed here (ref: "
                "runtime_env image_uri plugin)")
        raise RuntimeError(
            "container runtime envs are not wired to the worker "
            "launcher yet — run the cluster inside the image instead")


def _build_venv(pip: list, target: str, tool: str = "pip") -> str:
    import shutil as _shutil  # noqa: PLC0415
    import subprocess  # noqa: PLC0415
    import sys  # noqa: PLC0415
    import uuid as _uuid  # noqa: PLC0415

    use_uv = tool == "uv" and _shutil.which("uv") is not None
    if tool == "uv" and not use_uv:
        logger.warning("runtime_env uv requested but the uv binary is "
                       "missing — building with venv+pip instead")
    tmp = target + f".tmp.{os.getpid()}.{_uuid.uuid4().hex[:8]}"
    if use_uv:
        # uv resolves + installs an order of magnitude faster than pip
        # (ref: runtime_env/uv.py — same env shape, faster builder).
        proc = subprocess.run(
            ["uv", "venv", "--system-site-packages",
             "--python", sys.executable, tmp],
            capture_output=True, text=True)
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages",
             tmp],
            capture_output=True, text=True)
    if proc.returncode != 0:
        import shutil  # noqa: PLC0415

        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"venv creation failed:\n{proc.stderr[-2000:]}")
    # --system-site-packages chains to the BASE interpreter's
    # site-packages; when this process itself runs in a venv (the
    # common deployment), the parent's packages (torch, cloudpickle, …)
    # live elsewhere — chain them explicitly with a .pth so child
    # workers keep the full parent environment underneath the pip layer.
    import glob  # noqa: PLC0415
    import site  # noqa: PLC0415

    parent_sites = [p for p in site.getsitepackages() if os.path.isdir(p)]
    for sp in glob.glob(os.path.join(tmp, "lib", "python*",
                                     "site-packages")):
        with open(os.path.join(sp, "_art_parent.pth"), "w") as f:
            f.write("\n".join(parent_sites) + "\n")
    if use_uv:
        proc = subprocess.run(
            ["uv", "pip", "install", "--python",
             os.path.join(tmp, "bin", "python"), *pip],
            capture_output=True, text=True)
    else:
        proc = subprocess.run(
            # Unlike the JAX package, never ask the index for a newer
            # pip after the install: a node may have no network.
            [os.path.join(tmp, "bin", "python"), "-m", "pip",
             "install", "--no-input", "--disable-pip-version-check",
             *pip],
            capture_output=True, text=True)
    if proc.returncode != 0:
        import shutil  # noqa: PLC0415

        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"{tool} install {pip} failed:\n{proc.stderr[-2000:]}")
    open(os.path.join(tmp, ".art_ready"), "w").close()
    try:
        os.rename(tmp, target)
    except OSError:  # lost the build race — use the winner's venv
        import shutil  # noqa: PLC0415

        shutil.rmtree(tmp, ignore_errors=True)
    return target
