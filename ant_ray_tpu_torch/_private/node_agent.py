"""Per-node agent process (ref: the reference's per-node agents —
dashboard agent `dashboard/agent.py:24`, runtime-env agent
`runtime_env/agent/runtime_env_agent.py:167`, metrics agent
`_private/metrics_agent.py` — spawned and supervised by the raylet's
AgentManager, `src/ray/raylet/agent_manager.h`).

One process covers the four agent roles:

* **runtime-env builds** — package extraction and pip/uv/conda env
  materialization run HERE, so a slow or crashing build can never take
  the node daemon's event loop or process down with it;
* **log serving** — ListLogs/ReadLog over the session dir (the daemon
  keeps its own copies of these routes; the dashboard may talk to
  either);
* **node metrics** — OS-level gauges (load, memory, disk) for the
  head's metrics aggregation;
* **device telemetry** — per-card memory gauges read through NVML
  (``observability/device_stats.py`` ``card_memory_stats``: the whole
  card, whichever process holds the memory, without a CUDA context in
  this process) served on demand and published into the GCS metrics
  table on an interval, and on-demand trace capture (``AgentProfile`` ←
  dashboard ``POST /api/profile``): ``torch.profiler`` over this
  process for the requested duration, its Chrome trace archived into
  the session log dir so the existing log routes list and serve it.

The daemon restarts a dead agent with backoff and falls back to
in-process builds while the agent is down — agents are an isolation
upgrade, never a single point of failure.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time

from ant_ray_tpu_torch._private.config import global_config
from ant_ray_tpu_torch._private.protocol import ClientPool, RpcServer

logger = logging.getLogger(__name__)


class NodeAgent:
    def __init__(self, session_dir: str, gcs_address: str,
                 host: str = "127.0.0.1", port: int = 0):
        self._session_dir = session_dir
        self._gcs_address = gcs_address
        self._server = RpcServer(host, port)
        self._clients = ClientPool()
        self.stats = {"env_builds": 0, "env_build_failures": 0,
                      "log_reads": 0, "profiles_captured": 0,
                      "started_at": time.time()}
        self.address = ""
        self._profiling = threading.Lock()
        self._stop_publish = threading.Event()
        self._publish_thread: threading.Thread | None = None
        self._cpu_profiler = None

    def start(self) -> str:
        self._server.routes({
            "BuildRuntimeEnv": self._build_runtime_env,
            "AgentListLogs": self._list_logs,
            "AgentReadLog": self._read_log,
            "AgentMetrics": self._metrics,
            "AgentStats": self._get_stats,
            "AgentDeviceStats": self._device_stats,
            "AgentProfile": self._profile,
            "Ping": self._ping,
        })
        self.address = self._server.start()
        interval = global_config().device_stats_interval_s
        if interval > 0:
            self._publish_thread = threading.Thread(
                target=self._publish_device_stats_loop, args=(interval,),
                daemon=True, name="agent-device-stats")
            self._publish_thread.start()
        # Continuous CPU profiling: the agent publishes through its own
        # blocking GCS client (the publish runs on the sampler thread,
        # never the io loop).
        from ant_ray_tpu_torch.observability import cpu_profiler  # noqa: PLC0415

        self._cpu_profiler = None
        if global_config().cpu_profile_hz > 0:
            def _publish_profile(record, agent=self):
                agent._clients.get(agent._gcs_address).call(
                    "CpuProfileAdd", {"records": [record]}, timeout=5)

            def _publish_metric(payload, agent=self):
                agent._clients.get(agent._gcs_address).call(
                    "MetricRecord", payload, timeout=5)

            self._cpu_profiler = cpu_profiler.CpuProfiler(
                "agent", publish_fn=_publish_profile,
                metric_fn=_publish_metric).start()
        return self.address

    def stop(self) -> None:
        self._stop_publish.set()
        if self._cpu_profiler is not None:
            profiler, self._cpu_profiler = self._cpu_profiler, None
            profiler.stop(final_publish=False)
        if self._publish_thread is not None:
            self._publish_thread.join(timeout=2.0)
        self._server.stop()
        self._clients.close_all()

    async def _ping(self, _payload):
        return "pong"

    async def _get_stats(self, _payload):
        from ant_ray_tpu_torch.observability import device_stats  # noqa: PLC0415

        out = dict(self.stats)
        # NVML's first call loads the driver's library — keep the
        # agent's event loop responsive while it does.
        out["device"] = await asyncio.get_running_loop().run_in_executor(
            None, device_stats.card_memory_stats)
        return out

    # ---------------------------------------------------- runtime envs

    async def _build_runtime_env(self, payload):
        """Materialize a runtime env in THIS process — the daemon
        delegates here so builds are isolated from its event loop (ref:
        runtime_env_agent.py:167).  The build sequence itself is the
        shared runtime_env.materialize (identical to the daemon's
        in-process fallback)."""
        from ant_ray_tpu_torch._private import runtime_env as renv  # noqa: PLC0415

        gcs = self._clients.get(self._gcs_address)

        async def kv_get(key):
            return await gcs.call_async("KVGet", {"key": key},
                                        timeout=60)

        try:
            await renv.materialize(payload.get("wire"),
                                   self._session_dir, kv_get)
            self.stats["env_builds"] += 1
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 — reported to the daemon
            self.stats["env_build_failures"] += 1
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # ------------------------------------------------------------ logs

    async def _list_logs(self, _payload):
        from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415

        return log_serving.list_logs(self._session_dir)

    async def _read_log(self, payload):
        from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415

        self.stats["log_reads"] += 1
        return log_serving.read_log(self._session_dir, payload)

    # --------------------------------------------------------- metrics

    async def _metrics(self, _payload):
        """OS-level node gauges (the metrics-agent role)."""
        gauges: dict[str, float] = {}
        try:
            load1, load5, load15 = os.getloadavg()
            gauges.update({"load_1m": load1, "load_5m": load5,
                           "load_15m": load15})
        except OSError:
            pass
        try:
            fields = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    fields[key.strip()] = int(rest.strip().split()[0])
            gauges["mem_total_kb"] = float(fields.get("MemTotal", 0))
            gauges["mem_available_kb"] = float(
                fields.get("MemAvailable", 0))
        except (OSError, ValueError, IndexError):
            pass
        try:
            stat = os.statvfs(self._session_dir)
            gauges["disk_free_bytes"] = float(stat.f_bavail * stat.f_frsize)
        except OSError:
            pass
        return gauges

    # ------------------------------------------------ device telemetry

    async def _device_stats(self, _payload):
        """Per-card memory gauges in the node-metrics wire shape
        (observability/device_stats.py; a host without a card yields
        [])."""
        from ant_ray_tpu_torch.observability import device_stats  # noqa: PLC0415

        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: device_stats.device_stats_gauges(
                device_stats.card_memory_stats()))

    def _publish_device_stats_loop(self, interval: float) -> None:
        """Push per-card memory gauges into the GCS metrics table on an
        interval so /metrics carries art_device_hbm_* without a scrape
        hop.  Waits one full interval before the first publish."""
        from ant_ray_tpu_torch.observability import device_stats  # noqa: PLC0415

        # Tag with this node's identity: different nodes' chips must not
        # collide on one series, and the GCS prunes node-tagged series
        # when the node dies (stale-gauge expiry) — matching the short
        # id the dashboard's live scrape stamps.
        node_id = os.environ.get("ART_NODE_ID", "")[:12]
        while not self._stop_publish.wait(interval):
            try:
                gauges = device_stats.device_stats_gauges(
                    device_stats.card_memory_stats())
            except Exception:  # noqa: BLE001 — stay alive, retry later
                logger.warning("card memory unreadable", exc_info=True)
                continue
            gcs = self._clients.get(self._gcs_address)
            for g in gauges:
                if node_id:
                    g.setdefault("tags", {})["node_id"] = node_id
                try:
                    gcs.call("MetricRecord", g, timeout=5)
                except Exception:  # noqa: BLE001 — head restarting
                    break

    async def _profile(self, payload):
        """On-demand trace capture (dashboard POST /api/profile →
        daemon GetAgentInfo → here).  Runs ``torch.profiler`` over this
        process for ``duration_s`` (the CPU, and CUDA where the host has
        a card), exports its Chrome trace and archives it into the
        session log dir — a single .tar.gz the existing ListLogs/ReadLog
        routes serve.  One capture at a time (the profiler is a process
        singleton)."""
        duration = max(0.05, min(
            float((payload or {}).get("duration_s", 2.0)), 300.0))
        return await asyncio.get_running_loop().run_in_executor(
            None, self._capture_trace, duration)

    def _capture_trace(self, duration_s: float) -> dict:
        if not self._profiling.acquire(blocking=False):
            return {"error": "a trace capture is already in progress"}
        try:
            try:
                from torch import profiler  # noqa: PLC0415
            except Exception as e:  # noqa: BLE001 — report, don't crash
                return {"error": f"torch unavailable: {e}"}
            import tarfile  # noqa: PLC0415

            from ant_ray_tpu_torch._private import log_serving  # noqa: PLC0415
            from ant_ray_tpu_torch._private.accelerators import gpu  # noqa: PLC0415

            activities = [profiler.ProfilerActivity.CPU]
            if gpu.num_gpus() > 0:
                activities.append(profiler.ProfilerActivity.CUDA)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            trace_dir = os.path.join(self._session_dir, "profiles",
                                     f"torch-{stamp}-{os.getpid()}")
            os.makedirs(trace_dir, exist_ok=True)
            try:
                with profiler.profile(activities=activities) as prof:
                    time.sleep(duration_s)
                prof.export_chrome_trace(
                    os.path.join(trace_dir, "trace.json"))
            except Exception as e:  # noqa: BLE001
                return {"error":
                        f"trace capture failed: {type(e).__name__}: {e}"}
            logs_dir = log_serving.logs_dir(self._session_dir)
            os.makedirs(logs_dir, exist_ok=True)
            archive = f"torch-trace-{stamp}-{os.getpid()}.tar.gz"
            with tarfile.open(os.path.join(logs_dir, archive),
                              "w:gz") as tar:
                tar.add(trace_dir, arcname=os.path.basename(trace_dir))
            self.stats["profiles_captured"] += 1
            return {"trace_dir": trace_dir, "archive": archive,
                    "duration_s": duration_s}
        finally:
            self._profiling.release()


def main():  # pragma: no cover — exercised via subprocess in tests
    import argparse
    import signal

    parser = argparse.ArgumentParser()
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--monitor-pid", type=int, default=0)
    args = parser.parse_args()

    logging.basicConfig(
        level=global_config().log_level,
        format="[agent %(levelname)s %(asctime)s] %(message)s")
    agent = NodeAgent(args.session_dir, args.gcs_address)
    agent.start()
    print(f"AGENT_READY {agent.address}", flush=True)

    stop = False

    def _term(*_a):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop:
        time.sleep(0.2)
        if args.monitor_pid and not os.path.exists(
                f"/proc/{args.monitor_pid}"):
            break
    agent.stop()
    os._exit(0)


if __name__ == "__main__":
    main()
