"""NVIDIA GPU detection, slice topology and the maintenance notice.

The counterpart of the JAX package's ``_private/accelerators/tpu.py``:
the same functions, answered for a host with NVIDIA cards.

* **Cards.**  :func:`num_gpus` — the cards this host gives its
  processes: the driver's ``/proc/driver/nvidia/gpus/*`` entries, else
  the lines of ``nvidia-smi -L``, narrowed by ``CUDA_VISIBLE_DEVICES``
  as the CUDA runtime narrows them; the ``tpu_chips_override`` flag
  overrides the count, as it overrides the chip count in the JAX
  package.  ``services.default_resources`` advertises it as ``"GPU"``.
* **Slices.**  A ``topology`` string ``"AxB..."`` gives a slice's card
  count as the product; a slice packs :data:`GPU_HARDWARE_TABLE`'s
  cards per host of its generation (``gb200``'s 4 per compute tray
  reproduce the TPU table's 4-chip hosts).  On NVIDIA the counterpart
  of a TPU pod is the NVLink domain: where ``nvidia-smi -q`` reports a
  fabric ``ClusterUUID`` / ``CliqueId``, the pod is that clique;
  elsewhere (an HGX H100 host) the host is a slice of its own: pod name
  from the host name, worker id 0, topology ``1x<visible cards>``.
  ``ART_GPU_POD_NAME`` / ``ART_GPU_WORKER_ID`` / ``ART_GPU_TOPOLOGY``
  override detection, as GKE's ``TPU_*`` variables do for a TPU host.
* **Labels.**  :func:`node_labels` gives ``gpu-generation``,
  ``gpu-pod-name``, ``gpu-worker-id``, ``gpu-topology`` and
  ``gpu-pod-type``; the daemon of worker 0 of a slice advertises
  ``GPU-<pod_type>-head``.  A host where detection finds no card
  advertises no GPU label at all.
* **The maintenance notice.**  :func:`maintenance_notice` reads the
  ``testing_preemption_notice`` file (the chaos harness's stand-in) or
  the GCE ``maintenance-event`` attribute, which GPU VMs on GCE carry as
  TPU VMs do.  The metadata server is asked only where
  ``ART_GCE_METADATA_URL`` points at one (the tests' mock) or the DMI
  product name says "Google Compute Engine", so a host without network
  never pays a DNS stall.  The TPU-only identity attributes
  (``accelerator-type``, ``agent-worker-number``, ``tpu-env``) have no
  GPU counterpart and are not read.

Detection reads files and runs ``nvidia-smi``; it never imports torch
and never creates a CUDA context, because the GCS and the node daemon
must never touch the card.
"""

from __future__ import annotations

import glob
import logging
import os
import socket
import subprocess
import threading
import time
import urllib.error
import urllib.request

from ant_ray_tpu_torch._private.config import global_config

logger = logging.getLogger(__name__)

# generation -> (cards per host, dense bf16 peak TFLOP/s per card, HBM
# GB per card).  NVIDIA data-sheet values of the SXM parts: A100 80GB
# (312 TFLOP/s, 80 GB), H100 (989 TFLOP/s without sparsity, 80 GB), H200
# (989 TFLOP/s, 141 GB), on HGX boards of 8; GB200 from the GB200 NVL72
# sheet (360 PFLOP/s sparse bf16 and 13.4 TB HBM3e over 72 GPUs: 2500
# TFLOP/s dense and 186 GB a GPU), 4 GPUs a compute tray in an NVLink
# domain of up to 72 GPUs, the closest counterpart of a TPU pod.
GPU_HARDWARE_TABLE: dict[str, tuple[int, float, float]] = {
    "a100": (8, 312.0, 80),
    "h100": (8, 989.0, 80),
    "h200": (8, 989.0, 141),
    "gb200": (4, 2500.0, 186),
}

# Generations whose NVLink domain spans hosts: only their hosts ask
# ``nvidia-smi -q`` for a fabric clique (an HGX board's NVLink ends at
# its host, and the query costs a daemon's start about a second).
_MULTI_HOST_NVLINK = ("gb200",)

_PROC_GPUS = "/proc/driver/nvidia/gpus"
_DMI_PRODUCT = "/sys/class/dmi/id/product_name"
_SMI_TIMEOUT_S = 10.0
# Where /proc has no driver entries the count comes from nvidia-smi
# alone: on an H100 host of that kind one cluster start advertised no
# card while the detections around it found one, so a failed run is
# retried before the host reads as having none.
_SMI_ATTEMPTS = 3
_SMI_RETRY_S = 0.5

# GCE instance-metadata server.  The host is overridable so tests can
# stand up a local mock.
_METADATA_ATTRIBUTES_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/attributes/"
)
_METADATA_KEY_MAINTENANCE = "maintenance-event"
_MAINTENANCE_NONE = "NONE"


def _smi(args: list[str]) -> str | None:
    """stdout of ``nvidia-smi <args>``, or None once every attempt
    failed (no binary: None at once)."""
    failure = ""
    for attempt in range(_SMI_ATTEMPTS):
        if attempt:
            time.sleep(_SMI_RETRY_S)
        try:
            out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                                 text=True, timeout=_SMI_TIMEOUT_S,
                                 check=False)
        except OSError as e:
            logger.debug("nvidia-smi unavailable: %s", e)
            return None
        except subprocess.SubprocessError as e:
            failure = str(e)
            continue
        if out.returncode == 0:
            return out.stdout
        failure = f"exit {out.returncode}: {out.stderr.strip()[:200]}"
    logger.warning("nvidia-smi %s failed %d times (%s)", " ".join(args),
                   _SMI_ATTEMPTS, failure)
    return None


def _physical_count() -> int:
    try:
        count = len(os.listdir(_PROC_GPUS))
    except OSError:
        count = 0
    if count:
        return count
    out = _smi(["-L"])
    if out is None:
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


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
    """NVIDIA cards this host gives its processes (0 where none).  The
    ``tpu_chips_override`` flag overrides detection (the flag keeps the
    JAX package's name, so ``_system_config`` dicts written for it
    work here)."""
    override = global_config().tpu_chips_override
    if override >= 0:
        return override
    physical = _physical_count()
    mask = os.environ.get("CUDA_VISIBLE_DEVICES")
    if mask is None:
        return physical
    return _visible(physical, mask)


# ------------------------------------------------------------ slice math

def normalize_generation(name: str) -> str:
    """"NVIDIA H100 80GB HBM3" / "GPU-H100" / "h100-8" / "H100" ->
    "h100"; "NVIDIA A100-SXM4-80GB" -> "a100"."""
    name = name.strip().lower()
    for prefix in ("nvidia ", "gpu-"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name.replace("-", " ").split()[0] if name.strip() else name


def table_generation(device_name: str) -> str | None:
    """The :data:`GPU_HARDWARE_TABLE` row of a card named as
    ``torch.cuda.get_device_name()`` names it, or None: the table holds
    the SXM parts, so a PCIe or NVL card (a lower power limit, a lower
    peak) has no row."""
    lowered = device_name.lower()
    if "pcie" in lowered or " nvl" in lowered:
        return None
    gen = normalize_generation(device_name)
    return gen if gen in GPU_HARDWARE_TABLE else None


def topology_chip_count(topology: str) -> int:
    """"AxB" / "AxBxC" slice topology -> total cards."""
    count = 1
    for d in topology.lower().split("x"):
        count *= int(d)
    return count


def _cards_per_host(generation: str) -> int:
    entry = GPU_HARDWARE_TABLE.get(normalize_generation(generation))
    return entry[0] if entry else 8


def chips_per_host(topology: str, generation: str) -> int:
    """Cards per host in a slice: all of them where the slice fits one
    host of its generation, else the generation's cards per host (the
    JAX package's rule, with each generation's count in place of its
    4-or-8)."""
    total = topology_chip_count(topology)
    per_host = _cards_per_host(generation)
    return total if total <= per_host else per_host


def hosts_in_slice(topology: str, generation: str) -> int:
    total = topology_chip_count(topology)
    per_host = chips_per_host(topology, generation)
    return max(1, (total + per_host - 1) // per_host)


def infer_pod_type(topology: str, generation: str) -> str:
    """("2x4", "h100") -> "h100-8"."""
    return (f"{normalize_generation(generation)}-"
            f"{topology_chip_count(topology)}")


# ------------------------------------------------------------ detection

_generation_memo: list = []  # [(gen, source)] once positively detected


def _proc_model() -> str | None:
    """The ``Model:`` line of the driver's first card entry."""
    for info in sorted(glob.glob(os.path.join(_PROC_GPUS, "*",
                                              "information"))):
        try:
            with open(info) as f:
                for line in f:
                    key, _, value = line.partition(":")
                    if key.strip() == "Model" and value.strip():
                        return value.strip()
        except OSError:
            continue
    return None


def _detect() -> tuple[str, str] | None:
    if _generation_memo:
        return _generation_memo[0]
    found = None
    env = os.environ.get("ART_GPU_GENERATION")
    if env:
        found = (normalize_generation(env), "env")
    else:
        model = _proc_model()
        if model:
            found = (normalize_generation(model), "proc")
        else:
            out = _smi(["--query-gpu=name", "--format=csv,noheader"])
            names = [line for line in (out or "").splitlines()
                     if line.strip()]
            if names:
                found = (normalize_generation(names[0]), "nvidia-smi")
    if found:
        _generation_memo.append(found)
    return found


def detect_generation() -> str | None:
    """GPU generation of this host ("h100", ...), or None.  Order:
    ``ART_GPU_GENERATION`` -> the driver's ``/proc`` entry -> ``nvidia-smi
    --query-gpu=name``.  Only positive results memoize: a transiently
    failing ``nvidia-smi`` must not pin None for the process lifetime."""
    found = _detect()
    return found[0] if found else None


def generation_source() -> str | None:
    """Which source gave :func:`detect_generation`'s answer ("env",
    "proc" or "nvidia-smi"), or None where none did."""
    found = _detect()
    return found[1] if found else None


_fabric_memo: list = []  # [clique or None] once asked


def _detect_generation_cache_clear() -> None:
    _generation_memo.clear()
    _fabric_memo.clear()


detect_generation.cache_clear = _detect_generation_cache_clear  # test hook


def _fabric_clique() -> str | None:
    """``<ClusterUUID>-<CliqueId>`` of the card's NVLink fabric where
    ``nvidia-smi -q`` reports one (a GB200 NVL domain), else None.  Asked
    once a process, and only on a generation of
    :data:`_MULTI_HOST_NVLINK`."""
    if _fabric_memo:
        return _fabric_memo[0]
    clique = None
    out = (_smi(["-q"]) if detect_generation() in _MULTI_HOST_NVLINK
           and _physical_count() else None)
    if out:
        fields: dict[str, str] = {}
        in_fabric = False
        for line in out.splitlines():
            stripped = line.strip()
            if stripped == "Fabric":
                in_fabric = True
                continue
            if in_fabric:
                key, sep, value = stripped.partition(":")
                if not sep:
                    in_fabric = False
                    continue
                fields[key.strip()] = value.strip()
        uuid = fields.get("ClusterUUID", "")
        clique_id = fields.get("CliqueId", "")
        if uuid and uuid.upper() not in ("N/A", "") and clique_id \
                and clique_id.upper() != "N/A":
            clique = f"{uuid}-{clique_id}"
    _fabric_memo.append(clique)
    return clique


def current_pod_name(cards: int | None = None) -> str | None:
    """Name of the slice this host belongs to: ``ART_GPU_POD_NAME``,
    else the NVLink fabric's clique, else the host name on a host with a
    card (a host of its own slice); None without a card.  ``cards``:
    :func:`num_gpus` where the caller has it (each count may run
    ``nvidia-smi``)."""
    name = os.environ.get("ART_GPU_POD_NAME")
    if name:
        return name
    if not (num_gpus() if cards is None else cards):
        return None
    return _fabric_clique() or socket.gethostname()


def current_worker_id() -> int:
    """This host's index within its slice: ``ART_GPU_WORKER_ID``, else 0
    (a host that is its own slice is its worker 0)."""
    wid = os.environ.get("ART_GPU_WORKER_ID")
    try:
        return int(wid) if wid else 0
    except ValueError:
        return 0


def current_topology(cards: int | None = None) -> str | None:
    """``ART_GPU_TOPOLOGY``, else ``1x<visible cards>`` on a host that is
    its own slice; None in an NVLink domain whose shape nothing names,
    or without a card.  ``cards`` as for :func:`current_pod_name`."""
    topology = os.environ.get("ART_GPU_TOPOLOGY")
    if topology:
        return topology
    cards = num_gpus() if cards is None else cards
    if not cards or _fabric_clique():
        return None
    return f"1x{cards}"


def _table_entry(generation: str | None) -> tuple[int, float, float]:
    gen = normalize_generation(generation) if generation \
        else (detect_generation() or "h100")
    return GPU_HARDWARE_TABLE.get(gen, GPU_HARDWARE_TABLE["h100"])


def peak_bf16_tflops(generation: str | None = None) -> float:
    return _table_entry(generation)[1]


def hbm_gib_per_chip(generation: str | None = None) -> float:
    """HBM per card in GiB (the table holds the data sheet's GB)."""
    return _table_entry(generation)[2] * 1e9 / 2 ** 30


# ----------------------------------------------- GCE maintenance notice

def _metadata_base_url() -> str:
    return os.environ.get("ART_GCE_METADATA_URL", _METADATA_ATTRIBUTES_URL)


def _on_gce() -> bool:
    try:
        with open(_DMI_PRODUCT) as f:
            return "google compute engine" in f.read().lower()
    except OSError:
        return False


def _may_query_metadata() -> bool:
    if os.environ.get("ART_GCE_METADATA_URL"):
        return True  # test mock is wired up
    return _on_gce()


# After a failed lookup the server is considered unreachable for a grace
# window, so the 1 Hz watch does not pay a blocking probe each poll.
_metadata_backoff_until = 0.0
_METADATA_BACKOFF_S = 30.0
_METADATA_DEADLINE_S = 1.0


def _fetch_metadata_once(url: str) -> tuple[bool, str | None]:
    """(ok, value) — run in a worker thread; ok=False means transient."""
    req = urllib.request.Request(url, headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(
                req, timeout=_METADATA_DEADLINE_S) as resp:
            return True, (resp.read().decode() or None)
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return True, None  # attribute genuinely absent
        return False, None
    except (urllib.error.URLError, OSError, ValueError) as e:
        logger.debug("GCE metadata unavailable: %s", e)
        return False, None


def _fetch_metadata_deadline(url: str) -> tuple[bool, str | None]:
    """_fetch_metadata_once in a daemon thread joined with a hard
    deadline: DNS resolution is not bounded by urlopen's timeout, and
    the preemption watch must react within an announced grace window."""
    result: list[tuple[bool, str | None]] = []
    t = threading.Thread(
        target=lambda: result.append(_fetch_metadata_once(url)),
        daemon=True)
    t.start()
    t.join(_METADATA_DEADLINE_S + 0.3)
    if not result or not result[0][0]:
        return False, None
    return result[0]


def _metadata_backoff_clear() -> None:
    global _metadata_backoff_until
    _metadata_backoff_until = 0.0


def maintenance_watch_possible() -> bool:
    """Whether any notice source could ever fire on this host — the
    daemon's watch exits at once when none can (CPU test rigs and a
    card's machine without the notice file must not poll forever)."""
    if global_config().testing_preemption_notice:
        return True
    return not os.environ.get("ART_DISABLE_GCE_METADATA") and \
        _may_query_metadata()


def maintenance_notice() -> "tuple[str, float] | None":
    """A pending preemption/maintenance notice for this host, or None.

    Returns ``(reason, deadline_s)`` — ``deadline_s`` is the announced
    grace (seconds from now; 0.0 = none announced).  Sources, in order:

    * ``testing_preemption_notice`` (chaos harness): a file path whose
      existence is the notice; its first line may carry
      ``"<deadline_s> <reason...>"``.
    * The GCE ``maintenance-event`` metadata attribute (never cached: it
      changes over the instance's lifetime).
    """
    notice_path = global_config().testing_preemption_notice
    if notice_path:
        try:
            with open(notice_path) as f:
                first = f.readline().split(None, 1)
            deadline = float(first[0]) if first else 0.0
            reason = (first[1].strip() if len(first) > 1
                      else "testing preemption notice")
            return reason, deadline
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            return "testing preemption notice", 0.0
    global _metadata_backoff_until
    if os.environ.get("ART_DISABLE_GCE_METADATA") or \
            not _may_query_metadata():
        return None
    if time.monotonic() < _metadata_backoff_until:
        return None
    ok, value = _fetch_metadata_deadline(
        _metadata_base_url() + _METADATA_KEY_MAINTENANCE)
    if not ok:
        _metadata_backoff_until = time.monotonic() + _METADATA_BACKOFF_S
        return None
    if value is None or value.strip() in ("", _MAINTENANCE_NONE):
        return None
    return value.strip(), 0.0


maintenance_notice.cache_clear = _metadata_backoff_clear  # test hook


# ---------------------------------------------------------------- labels

def node_labels() -> dict[str, str]:
    """Labels a node daemon advertises for slice-aware placement."""
    labels: dict[str, str] = {}
    gen = detect_generation()
    if gen:
        labels["gpu-generation"] = gen
    cards = num_gpus()
    pod = current_pod_name(cards)
    if pod:
        labels["gpu-pod-name"] = pod
        labels["gpu-worker-id"] = str(current_worker_id())
    topology = current_topology(cards)
    if topology:
        labels["gpu-topology"] = topology
        if gen:
            labels["gpu-pod-type"] = infer_pod_type(topology, gen)
    return labels


def slice_groups(pod_names) -> list:
    """Group ranks by the slice they sit on: ranks whose nodes advertise
    the same ``gpu-pod-name`` share NVLink; distinct pod names only reach
    each other over the network.  Input is one pod name per rank
    (``None``/"" ranks are a standalone slice each — a CPU stand-in
    host is its own slice).  Returns rank tuples, ordered by each
    slice's lowest rank, for ``SliceTopology.from_labels``."""
    by_pod: dict = {}
    for rank, pod in enumerate(pod_names):
        key = pod if pod else f"_solo_{rank}"
        by_pod.setdefault(key, []).append(rank)
    return [tuple(ranks)
            for ranks in sorted(by_pod.values(), key=lambda r: r[0])]
