"""Build and load the hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``ant_ray_tpu_torch/_build/`` (listed in .gitignore), named after a hash
of its sources and flags so an edit triggers a rebuild, and loaded with
``ctypes``.  Nothing here includes PyTorch's headers, which keeps a build
to seconds.  The compiler's output (``-Xptxas=-v``: registers, shared
memory and spills per kernel) is kept as ``<library>.log``.  A failed
build raises; there is no fallback.

Every source builds with the same flags, and a change to any ``.cuh``
header rebuilds every library.  The tensor-core kernels
(``flash_attention_fwd_sm90.cu`` and ``flash_attention_bwd_sm90.cu``,
with their shared ``flash_attention_sm90.cuh``) need no more: their TMA
maps are encoded by ``cuTensorMapEncodeTiled``, a driver function that
they fetch through the runtime (``cudaGetDriverEntryPoint``), so no
library links ``libcuda``, and they write their PTX by hand, so no
CUTLASS include path.

:func:`build_all` starts one ``nvcc`` per source at once, so the
kernels build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built;
    returns (target, process or None)."""
    target = _library_path(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, cmd)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    # ptxas' registers / shared memory / spills per kernel, kept beside
    # the library for whoever wants to read them.
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)


def build_all() -> list[str]:
    """Build every kernel source, all nvcc processes at once; returns the
    kernel names.  Loading afterwards costs no compile."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        jobs = [(n, *_start(n)) for n in names]
        for name, target, job in jobs:
            _finish(name, target, job)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target, job = _start(name)
            _finish(name, target, job)
            lib = ctypes.CDLL(str(target))
            _loaded[name] = lib
        return lib
