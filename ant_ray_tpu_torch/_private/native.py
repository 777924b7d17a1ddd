"""Loader for the native extension (ant_ray_tpu_torch/native/store_core.cpp).

Builds ``art_torch_native`` on demand with the system toolchain into the
package's git-ignored ``_build/`` directory (beside the CUDA kernels'
libraries), named after a hash of its sources and the Python version, so
an edit triggers a rebuild.  Falls back cleanly (returns None) where no
compiler is available, so the pure-Python paths keep working: the
object store then keeps one file per object.

The sources are a copy of the JAX package's ``native/`` files; the module
and its types are named ``art_torch_native`` so both extensions can be
loaded into one process.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading

logger = logging.getLogger(__name__)

MODULE_NAME = "art_torch_native"

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, "native")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")

_lock = threading.Lock()
_module = None
_attempted = False


def _source_path() -> str:
    return os.path.join(SOURCE_DIR, "store_core.cpp")


def library_path() -> str:
    """Where the built module lives: ``_build/`` under a name that hashes
    the sources and the interpreter's version."""
    digest = hashlib.sha256()
    for name in ("store_core.cpp", "channel_core.h"):
        with open(os.path.join(SOURCE_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(
        BUILD_DIR,
        f"{MODULE_NAME}-{digest.hexdigest()[:16]}"
        f"-py{sys.version_info[0]}{sys.version_info[1]}.so")


def load_native():
    """The art_torch_native module, building it if needed; None if
    unavailable."""
    global _module, _attempted
    with _lock:
        if _module is not None or _attempted:
            return _module
        _attempted = True
        src = _source_path()
        if not os.path.exists(src):
            return None
        so_path = library_path()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            include = sysconfig.get_path("include")
            # Per-process temp name: concurrent processes may race to
            # build; each compiles privately, rename is atomic.
            tmp_path = f"{so_path}.tmp.{os.getpid()}"
            cmd = [
                "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                f"-I{include}", f"-I{SOURCE_DIR}",
                src, "-o", tmp_path,
            ]
            try:
                # Serializing the one-time g++ build is this lock's
                # purpose; every later call returns the cached module.
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.rename(tmp_path, so_path)
            except (subprocess.CalledProcessError, OSError,
                    subprocess.TimeoutExpired) as e:
                stderr = getattr(e, "stderr", b"")
                logger.warning("%s build failed: %s %s", MODULE_NAME, e,
                               stderr.decode()[:500] if stderr else "")
                return None
        spec = importlib.util.spec_from_file_location(MODULE_NAME, so_path)
        module = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(module)
        except Exception as e:  # noqa: BLE001
            logger.warning("%s load failed: %s", MODULE_NAME, e)
            return None
        _module = module
        return _module
