"""The port's GPU detection and slice topology
(``_private/accelerators/gpu.py``) against the JAX package's TPU module
(``_private/accelerators/tpu.py``): the twins of the 11 tests of
tests/test_accelerators.py.

Where the JAX package answers in TPU terms, a twin maps them: ``v4``
(4 chips a host) is held against ``gb200`` (4 cards a compute tray) on
every topology, ``v5e`` (8 chips a host) against ``h100`` (8 cards a
board) where the slice fits one host; keys ``tpu-*`` become ``gpu-*``.
Detection runs against a fake ``/proc/driver/nvidia/gpus`` tree and a
fake ``nvidia-smi`` on ``PATH``; the maintenance event against the same
local metadata mock (``ART_GCE_METADATA_URL``) in both packages.
Integer results are compared exactly."""

import http.server
import os
import stat
import threading

import pytest

from ant_ray_tpu._private.accelerators import tpu
from ant_ray_tpu_torch._private.accelerators import gpu

TOPOLOGIES = ("1x1", "2x2", "2x4", "4x4", "2x8", "4x8", "8x8", "2x2x2",
              "4x4x4")


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch, tmp_path):
    for var in ("ART_DISABLE_GCE_METADATA", "ART_GCE_METADATA_URL",
                "ART_TPU_GENERATION", "TPU_ACCELERATOR_TYPE", "TPU_NAME",
                "TPU_WORKER_ID", "TPU_TOPOLOGY", "ART_GPU_GENERATION",
                "ART_GPU_POD_NAME", "ART_GPU_WORKER_ID", "ART_GPU_TOPOLOGY",
                "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    # No card, no nvidia-smi, no DMI name unless a test fakes them.
    monkeypatch.setattr(gpu, "_PROC_GPUS", str(tmp_path / "no-proc"))
    monkeypatch.setattr(gpu, "_DMI_PRODUCT", str(tmp_path / "no-dmi"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    for module in (tpu, gpu):
        module.detect_generation.cache_clear()
    tpu.get_tpu_metadata.cache_clear()
    gpu.maintenance_notice.cache_clear()
    yield
    for module in (tpu, gpu):
        module.detect_generation.cache_clear()
    tpu.get_tpu_metadata.cache_clear()
    gpu.maintenance_notice.cache_clear()


def _fake_proc(tmp_path, monkeypatch, model: str, cards: int):
    root = tmp_path / "proc-gpus"
    for i in range(cards):
        entry = root / f"0000:{i:02x}:00.0"
        entry.mkdir(parents=True)
        (entry / "information").write_text(
            f"Model: \t\t {model}\nIRQ:   \t\t 42\nBus Type: \t PCIe\n")
    monkeypatch.setattr(gpu, "_PROC_GPUS", str(root))


def _fake_smi(tmp_path, monkeypatch, names: list, query: str = ""):
    """An ``nvidia-smi`` on PATH: ``-L`` lists the cards, ``--query-gpu``
    names them, ``-q`` prints ``query``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    listing = "\n".join(f"GPU {i}: {n} (UUID: GPU-{i:08d})"
                        for i, n in enumerate(names))
    (bin_dir / "q.txt").write_text(query)
    script = bin_dir / "nvidia-smi"
    script.write_text(
        "#!/bin/sh\n"
        'case "$1" in\n'
        f"  -L) printf '%s\\n' '{listing}' ;;\n"
        f"  --query-gpu=name) printf '%s\\n' {' '.join(repr(n) for n in names)} ;;\n"
        f"  -q) while IFS= read -r l; do printf '%s\\n' \"$l\"; done"
        f" < '{bin_dir / 'q.txt'}' ;;\n"
        "  *) exit 2 ;;\n"
        "esac\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))


# ----------------------------------------------------------- hardware table

def test_v5e_v6e_are_8_chip_hosts():
    """The hosts' sizes: gb200 hosts 4 cards as v2-v5p host 4 chips, the
    HGX generations 8 as v5e/v6e host 8 (NVIDIA data sheets)."""
    assert gpu.GPU_HARDWARE_TABLE["gb200"][0] == tpu.TPU_HARDWARE_TABLE["v4"][0]
    for gen in ("a100", "h100", "h200"):
        assert gpu.GPU_HARDWARE_TABLE[gen][0] == \
            tpu.TPU_HARDWARE_TABLE["v5e"][0] == 8
    assert gpu.peak_bf16_tflops("h100") == 989.0
    assert gpu.peak_bf16_tflops("NVIDIA A100-SXM4-80GB") == 312.0
    assert gpu.hbm_gib_per_chip("h200") == pytest.approx(141e9 / 2 ** 30)


def test_normalize_generation():
    assert gpu.normalize_generation("NVIDIA H100 80GB HBM3") == "h100"
    assert gpu.normalize_generation("GPU-H100") == "h100"
    assert gpu.normalize_generation("h100-8") == "h100"
    assert gpu.normalize_generation("NVIDIA A100-SXM4-80GB") == "a100"
    assert gpu.normalize_generation("GB200") == "gb200"
    # The same shapes of name as the JAX package's.
    assert tpu.normalize_generation("TPU-V5E") == "v5e"
    assert tpu.normalize_generation("v6e-8") == "v6e"
    assert gpu.table_generation("NVIDIA H100 80GB HBM3") == "h100"
    assert gpu.table_generation("NVIDIA H100 PCIe") is None
    assert gpu.table_generation("NVIDIA H100 NVL") is None


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_chips_per_host_slice_rule(topology):
    """gb200 follows v4's 4-a-host rule on every topology; h100 follows
    v5e's wherever the slice fits one host, and packs 8 a host beyond."""
    assert gpu.chips_per_host(topology, "GB200") == \
        tpu.chips_per_host(topology, "v4") or \
        tpu.topology_chip_count(topology) < 4
    count = tpu.topology_chip_count(topology)
    assert gpu.topology_chip_count(topology) == count
    if count <= 8:
        assert gpu.chips_per_host(topology, "h100") == \
            tpu.chips_per_host(topology, "v5e") == count
    else:
        assert gpu.chips_per_host(topology, "h100") == 8
    if count < 4:      # a slice smaller than a host holds just its cards
        assert gpu.chips_per_host(topology, "gb200") == count


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hosts_in_slice(topology):
    assert gpu.hosts_in_slice(topology, "gb200") == \
        tpu.hosts_in_slice(topology, "v4")
    count = tpu.topology_chip_count(topology)
    assert gpu.hosts_in_slice(topology, "h100") == max(1, -(-count // 8))
    if count <= 8:
        assert gpu.hosts_in_slice(topology, "h100") == \
            tpu.hosts_in_slice(topology, "v5e") == 1


def test_infer_pod_type():
    assert gpu.infer_pod_type("2x4", "h100") == "h100-8"
    for topology in TOPOLOGIES:
        assert gpu.infer_pod_type(topology, "GPU-GB200") == \
            tpu.infer_pod_type(topology, "TPU-V4").replace("v4", "gb200")


# ------------------------------------------------------------- detection

def test_metadata_generation_detection(tmp_path, monkeypatch):
    """The generation from the driver's /proc entry, else from
    ``nvidia-smi --query-gpu=name``; each names its source."""
    _fake_proc(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3", 8)
    assert gpu.detect_generation() == "h100"
    assert gpu.generation_source() == "proc"
    assert gpu.num_gpus() == 8
    gpu.detect_generation.cache_clear()
    monkeypatch.setattr(gpu, "_PROC_GPUS", str(tmp_path / "gone"))
    _fake_smi(tmp_path, monkeypatch, ["NVIDIA A100-SXM4-80GB"] * 2)
    assert gpu.detect_generation() == "a100"
    assert gpu.generation_source() == "nvidia-smi"
    assert gpu.num_gpus() == 2


def test_metadata_pod_name_and_worker_id(tmp_path, monkeypatch):
    """An HGX host is a slice of its own (host name, worker 0); an
    NVLink fabric's clique names the pod; the environment wins."""
    _fake_proc(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3", 8)
    import socket

    assert gpu.current_pod_name() == socket.gethostname()
    assert gpu.current_worker_id() == 0
    gpu.detect_generation.cache_clear()
    _fake_proc(tmp_path / "gb", monkeypatch, "NVIDIA GB200", 4)
    _fake_smi(tmp_path, monkeypatch, ["NVIDIA GB200"] * 4, query=(
        "GPU 00000000:01:00.0\n"
        "    Fabric\n"
        "        State                             : Completed\n"
        "        Status                            : Success\n"
        "        CliqueId                          : 7\n"
        "        ClusterUUID                       : abc-123\n"
        "    Processes                             : None\n"))
    assert gpu.current_pod_name() == "abc-123-7"
    assert gpu.current_topology() is None     # the domain's shape unnamed
    monkeypatch.setenv("ART_GPU_POD_NAME", "nvl72-a")
    monkeypatch.setenv("ART_GPU_WORKER_ID", "3")
    assert gpu.current_pod_name() == "nvl72-a"
    assert gpu.current_worker_id() == 3


def test_metadata_topology_from_tpu_env(tmp_path, monkeypatch):
    """A host of its own slice is ``1x<visible cards>``;
    ``ART_GPU_TOPOLOGY`` wins, as ``TPU_TOPOLOGY`` does."""
    _fake_proc(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3", 8)
    assert gpu.current_topology() == "1x8"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert gpu.current_topology() == "1x2"
    monkeypatch.setenv("ART_GPU_TOPOLOGY", "2x8")
    monkeypatch.setenv("TPU_TOPOLOGY", "2x8")
    assert gpu.current_topology() == tpu.current_topology() == "2x8"


def test_gke_env_wins_over_metadata(tmp_path, monkeypatch):
    _fake_proc(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3", 1)
    monkeypatch.setenv("ART_GPU_GENERATION", "H200")
    monkeypatch.setenv("ART_TPU_GENERATION", "v6e-8")
    assert gpu.detect_generation() == "h200"
    assert gpu.generation_source() == "env"
    assert tpu.detect_generation() == "v6e"


def test_metadata_gated_off_without_tpu_devices(monkeypatch):
    """Hosts that are not on GCE never query the metadata server (no DNS
    stall in daemon startup), and a host without notice sources runs no
    watch; no card means no GPU and no labels."""
    monkeypatch.setattr(tpu, "_sysfs_chip_count", lambda: 0)
    assert tpu.get_tpu_metadata("accelerator-type") is None
    assert tpu.maintenance_notice() is None
    assert gpu.maintenance_notice() is None
    assert not tpu.maintenance_watch_possible()
    assert not gpu.maintenance_watch_possible()
    assert gpu.num_gpus() == 0
    assert gpu.detect_generation() is None
    assert gpu.node_labels() == tpu.node_labels() == {}


def test_node_labels_with_metadata(tmp_path, monkeypatch):
    _fake_proc(tmp_path, monkeypatch, "NVIDIA H100 80GB HBM3", 8)
    monkeypatch.setenv("ART_GPU_POD_NAME", "my-slice")
    monkeypatch.setenv("ART_GPU_WORKER_ID", "1")
    monkeypatch.setenv("ART_GPU_TOPOLOGY", "2x8")
    labels = gpu.node_labels()
    assert labels == {"gpu-generation": "h100", "gpu-pod-name": "my-slice",
                      "gpu-worker-id": "1", "gpu-topology": "2x8",
                      "gpu-pod-type": "h100-16"}
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "v5litepod-16")
    monkeypatch.setenv("TPU_NAME", "my-slice")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("TPU_TOPOLOGY", "4x4")
    want = tpu.node_labels()
    assert sorted(k.replace("tpu-", "gpu-") for k in want) == sorted(labels)
    assert want["tpu-pod-type"] == "v5e-16"


# ----------------------------------------------- the maintenance event

class _MetadataHandler(http.server.BaseHTTPRequestHandler):
    attributes = {}

    def do_GET(self):  # noqa: N802 — stdlib API
        if self.headers.get("Metadata-Flavor") != "Google":
            self.send_response(403)
            self.end_headers()
            return
        value = self.attributes.get(self.path.rsplit("/", 1)[-1])
        if value is None:
            self.send_response(404)
            self.end_headers()
            return
        body = value.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def metadata_server(monkeypatch):
    server = http.server.HTTPServer(("127.0.0.1", 0), _MetadataHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv(
        "ART_GCE_METADATA_URL",
        f"http://127.0.0.1:{server.server_address[1]}/attributes/")
    yield _MetadataHandler
    server.shutdown()
    _MetadataHandler.attributes = {}


@pytest.mark.parametrize("event,want", [
    (None, None), ("NONE", None),
    ("TERMINATE_ON_HOST_MAINTENANCE",
     ("TERMINATE_ON_HOST_MAINTENANCE", 0.0))])
def test_maintenance_event_from_the_metadata_mock(metadata_server, event,
                                                  want):
    """Both packages read the GCE ``maintenance-event`` attribute from
    the same mock, alike."""
    metadata_server.attributes = ({} if event is None
                                  else {"maintenance-event": event})
    assert tpu.maintenance_watch_possible() and gpu.maintenance_watch_possible()
    assert gpu.maintenance_notice() == tpu.maintenance_notice() == want


def test_gce_dmi_name_gates_the_metadata_server(tmp_path, monkeypatch):
    dmi = tmp_path / "product_name"
    dmi.write_text("Google Compute Engine\n")
    monkeypatch.setattr(gpu, "_DMI_PRODUCT", str(dmi))
    assert gpu.maintenance_watch_possible()
    monkeypatch.setenv("ART_DISABLE_GCE_METADATA", "1")
    assert not gpu.maintenance_watch_possible()
    assert not os.environ.get("ART_GCE_METADATA_URL")


def test_detection_imports_no_torch():
    """The GCS and the daemon never touch the card: detection imports no
    torch (a fresh interpreter, so this process's imports cannot hide
    it)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from ant_ray_tpu_torch._private.accelerators import gpu;"
         "gpu.node_labels(); gpu.num_gpus(); print('torch' in sys.modules)"],
        capture_output=True, text=True, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "False"
