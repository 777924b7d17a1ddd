"""Cluster process bootstrap (ref: python/ray/_private/services.py +
node.py — start/stop of gcs_server, raylet, workers).

The port starts the GCS, one node daemon and, where
``include_dashboard`` is on and aiohttp is installed, the dashboard, all
its own modules (the daemon starts the node agent).  The JAX package also
stashes a TPU-plugin trigger from the daemons' environment and restores
it for workers (``control_plane_env`` / ``accelerator_env``); nothing in
the port's site configuration imports an accelerator library at
interpreter start, so the daemons, the workers and the dashboard's job
drivers inherit the launcher's environment as it is (``CUDA_VISIBLE_DEVICES``
included: a job driver sees the cards its launcher saw)."""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid

from ant_ray_tpu_torch._private.protocol import ClientPool, find_free_port

logger = logging.getLogger(__name__)

_READY_TIMEOUT_S = 30.0


def _child_env() -> dict:
    """The launcher's environment with the directory that holds this
    package first on ``PYTHONPATH``: the GCS, the node daemons and
    (through them) the workers then run the same copy of the port as
    the driver, whatever their working directory."""
    env = os.environ.copy()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rest = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
            if p and p != root]
    env["PYTHONPATH"] = os.pathsep.join([root, *rest])
    return env


def _wait_ready(proc: subprocess.Popen, marker: str) -> str:
    """Read the child's stdout until `<marker> <address>` appears."""
    deadline = time.monotonic() + _READY_TIMEOUT_S
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"process exited (code={proc.poll()}) before ready")
        text = line.decode(errors="replace").strip()
        if text.startswith(marker):
            return text.split(" ", 1)[1]
    raise RuntimeError(f"timed out waiting for {marker}")


def start_gcs(session_dir: str,
              port: int | None = None,
              ha_replica_id: str | None = None
              ) -> tuple[subprocess.Popen, str]:
    """Start (or restart — same port + store file) the GCS head.

    Tables persist to ``<session_dir>/gcs_store.db`` so a restarted head
    resumes the cluster (ref: Redis-backed GCS fault tolerance,
    src/ray/gcs/store_client/redis_store_client.h).  Export events go
    to ``<session_dir>/export_events``.  With ``ha_replica_id`` the
    process joins the replicated control plane over that same store:
    the lease elects a leader, the rest run as warm standbys (follower
    reads + NotLeader redirects)."""
    port = port or find_free_port()
    store = os.path.join(session_dir, "gcs_store.db")
    cmd = [sys.executable, "-m", "ant_ray_tpu_torch._private.gcs",
           "--port", str(port), "--store", store,
           "--export-dir", os.path.join(session_dir, "export_events"),
           "--monitor-pid", str(os.getpid())]
    if ha_replica_id:
        cmd += ["--ha-replica-id", ha_replica_id]
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE, stderr=_log_file(session_dir, "gcs.err"),
        env=_child_env(), start_new_session=True)
    address = _wait_ready(proc, "GCS_READY")
    return proc, address


def start_node(gcs_address: str, resources: dict, session_dir: str,
               labels: dict | None = None) -> tuple[subprocess.Popen, str]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "ant_ray_tpu_torch._private.node_daemon",
         "--gcs-address", gcs_address,
         "--resources", json.dumps(resources),
         "--session-dir", session_dir,
         "--labels", json.dumps(labels or {}),
         "--monitor-pid", str(os.getpid())],
        stdout=subprocess.PIPE, stderr=_log_file(session_dir, "noded.err"),
        env=_child_env(), start_new_session=True)
    address = _wait_ready(proc, "NODED_READY")
    return proc, address


def _log_file(session_dir: str, name: str):
    log_dir = os.path.join(session_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    return open(os.path.join(log_dir, name), "ab")


def default_resources(num_cpus: int | None, num_tpus: int | None,
                      resources: dict | None,
                      num_gpus: int | None = None) -> dict:
    """The node's resources: ``CPU`` (all cores unless given), ``GPU``
    (the detected NVIDIA cards unless ``num_gpus`` overrides them) and
    ``TPU`` only where ``num_tpus`` names it, as the JAX package's
    ``init(num_tpus=)`` does (a GPU host detects no chips)."""
    out = dict(resources or {})
    out["CPU"] = float(num_cpus if num_cpus is not None
                       else (os.cpu_count() or 1))
    if num_tpus is not None:
        out["TPU"] = float(num_tpus)
    if num_gpus is not None:
        out["GPU"] = float(num_gpus)
    else:
        from ant_ray_tpu_torch._private.accelerators import gpu  # noqa: PLC0415

        detected = gpu.num_gpus()
        if detected:
            out["GPU"] = float(detected)
    return out


SESSION_PREFIX = "art_torch_session_"


def new_session_dir() -> str:
    """A fresh session directory under the temporary directory
    (``TMPDIR``), named ``art_torch_session_*`` so a leftover directory
    names the package that made it."""
    session_dir = os.path.join(
        tempfile.gettempdir(), f"{SESSION_PREFIX}{uuid.uuid4().hex[:10]}")
    os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
    return session_dir


def remove_session_dir(session_dir: str) -> None:
    """Remove a session directory this process made (logs, the GCS
    store, spill files) once its processes are gone."""
    if os.path.basename(session_dir.rstrip("/")).startswith(SESSION_PREFIX):
        shutil.rmtree(session_dir, ignore_errors=True)


def start_dashboard(gcs_address: str, session_dir: str
                    ) -> tuple[subprocess.Popen, str]:
    """Start the dashboard (its log in the session's ``dash.err``; its
    jobs' logs in ``logs/job-<id>.log``)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ant_ray_tpu_torch._private.dashboard",
         "--gcs-address", gcs_address,
         "--session-dir", session_dir,
         "--monitor-pid", str(os.getpid())],
        stdout=subprocess.PIPE, stderr=_log_file(session_dir, "dash.err"),
        env=_child_env(), start_new_session=True)
    url = _wait_ready(proc, "DASH_READY")
    return proc, url


def start_cluster(num_cpus: int | None = None, num_tpus: int | None = None,
                  resources: dict | None = None,
                  num_gpus: int | None = None) -> dict:
    """Start head (GCS) + one node daemon (+ the dashboard where
    ``include_dashboard`` is on); returns addresses + procs."""
    from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

    session_dir = new_session_dir()
    procs = []
    dashboard_url = ""
    try:
        gcs_proc, gcs_address = start_gcs(session_dir)
        procs.append(gcs_proc)
        node_proc, node_address = start_node(
            gcs_address,
            default_resources(num_cpus, num_tpus, resources, num_gpus),
            session_dir)
        procs.insert(0, node_proc)
        want_dashboard = global_config().include_dashboard
        if want_dashboard and importlib.util.find_spec("aiohttp") is None:
            logger.warning("aiohttp not installed; dashboard (state API, "
                           "/metrics, job server) disabled")
            want_dashboard = False
        if want_dashboard:
            try:
                dash_proc, dashboard_url = start_dashboard(
                    gcs_address, session_dir)
            except Exception as e:  # noqa: BLE001 — dashboard is optional
                logger.warning("dashboard failed to start: %s", e)
            else:
                procs.insert(0, dash_proc)
                # Published for drivers that join later and the jobs SDK.
                pool = ClientPool()
                try:
                    pool.get(gcs_address).call("KVPut", {
                        "key": "dashboard_url",
                        "value": dashboard_url.encode()}, retries=3)
                finally:
                    pool.close_all()
    except Exception:
        stop_processes(procs)
        remove_session_dir(session_dir)
        raise
    store_dir = store_dir_of(node_address)
    return {
        "gcs_address": gcs_address,
        "node_address": node_address,
        "store_dir": store_dir,
        "session_dir": session_dir,
        "processes": procs,
        "dashboard_url": dashboard_url,
    }


def store_dir_of(node_address: str) -> str:
    pool = ClientPool()
    try:
        info = pool.get(node_address).call("GetNodeInfo", retries=3)
        return info.object_store_dir
    finally:
        pool.close_all()


def find_local_node(gcs_address: str) -> tuple[str, str]:
    """Pick a node for a connecting driver (first alive node)."""
    pool = ClientPool()
    try:
        nodes = pool.get(gcs_address).call("GetAllNodes", retries=5)
        for info in nodes.values():
            if info.alive:
                return info.address, info.object_store_dir
        raise RuntimeError("no alive nodes in cluster")
    finally:
        pool.close_all()


def stop_processes(procs: list) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + 15
    for proc in procs:
        remaining = max(0.1, deadline - time.monotonic())
        try:
            proc.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
