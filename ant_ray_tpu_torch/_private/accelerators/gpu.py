"""NVIDIA GPU detection for the node daemon and the launcher.

The counterpart of the JAX package's ``accelerators/tpu.py``: the
functions the daemon and ``services.py`` call, answered for a host with
NVIDIA cards.

* :func:`num_gpus` — the cards this host gives its processes: the
  driver's ``/proc/driver/nvidia/gpus/*`` entries, else the lines of
  ``nvidia-smi -L``, narrowed by ``CUDA_VISIBLE_DEVICES`` as the CUDA
  runtime narrows them.  ``services.default_resources`` advertises it as
  ``"GPU"``.
* :func:`node_labels` — none yet: GPU placement (card-aware bundles,
  NVLink islands) is ROADMAP queue A item 9.

``tpu.py``'s ``maintenance_watch_possible`` and ``maintenance_notice``
have no counterpart yet: a GPU host has no maintenance-event source the
port reads, so the daemon has no preemption watch (item 9 brings both).

Detection reads files and runs ``nvidia-smi``; it never imports torch
and never creates a CUDA context, because the GCS and the node daemon
must never touch the card.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time

logger = logging.getLogger(__name__)

_PROC_GPUS = "/proc/driver/nvidia/gpus"
_SMI_TIMEOUT_S = 10.0
# Where /proc has no driver entries the count comes from nvidia-smi
# alone: on an H100 host of that kind one cluster start advertised no
# card while the detections around it found one, so a failed run is
# retried before the host reads as having none.
_SMI_ATTEMPTS = 3
_SMI_RETRY_S = 0.5


def _physical_count() -> int:
    try:
        count = len(os.listdir(_PROC_GPUS))
    except OSError:
        count = 0
    if count:
        return count
    for attempt in range(_SMI_ATTEMPTS):
        if attempt:
            time.sleep(_SMI_RETRY_S)
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=_SMI_TIMEOUT_S,
                                 check=False)
        except OSError as e:
            logger.debug("nvidia-smi unavailable: %s", e)
            return 0
        except subprocess.SubprocessError as e:
            failure = str(e)
            continue
        if out.returncode == 0:
            return sum(1 for line in out.stdout.splitlines()
                       if line.startswith("GPU "))
        failure = f"exit {out.returncode}: {out.stderr.strip()[:200]}"
    logger.warning("nvidia-smi -L failed %d times (%s): no GPU advertised",
                   _SMI_ATTEMPTS, failure)
    return 0


def _visible(physical: int, mask: str) -> int:
    """Cards left by a ``CUDA_VISIBLE_DEVICES`` mask: its entries up to
    the first invalid one (an index out of range or not a number nor a
    ``GPU-``/``MIG-`` UUID), as the CUDA runtime reads it."""
    count = 0
    for entry in (e.strip() for e in mask.split(",")):
        if entry.isdigit() and int(entry) < physical:
            count += 1
        elif entry.startswith(("GPU-", "MIG-")):
            count += 1
        else:
            break
    return min(count, physical)


def num_gpus() -> int:
    """NVIDIA cards this host gives its processes (0 where none)."""
    physical = _physical_count()
    mask = os.environ.get("CUDA_VISIBLE_DEVICES")
    if mask is None:
        return physical
    return _visible(physical, mask)


def node_labels() -> dict[str, str]:
    """Labels a node daemon advertises: none for a GPU host yet (ROADMAP
    queue A item 9)."""
    return {}
