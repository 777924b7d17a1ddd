"""Job submission SDK (ref: python/ray/job_submission/__init__.py —
JobSubmissionClient over the dashboard's REST API; stdlib urllib, no
extra dependency)."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"
    STOPPED = "STOPPED"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"

    TERMINAL = {STOPPED, SUCCEEDED, FAILED}


class JobSubmissionClient:
    """client = JobSubmissionClient("http://127.0.0.1:<dash-port>")

    With no address, discovers the current cluster's dashboard from GCS
    KV (requires an active ``art.init`` connection).
    """

    def __init__(self, address: str | None = None):
        if address is None:
            from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

            global_worker._check_connected()
            blob = global_worker.runtime._gcs.call(
                "KVGet", {"key": "dashboard_url"}, retries=3)
            if not blob:
                raise RuntimeError(
                    "cluster has no dashboard (include_dashboard=False?)")
            address = blob.decode()
        self._base = address.rstrip("/")

    def _request(self, method: str, path: str, body: dict | None = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read().decode()).get("error", "")
            except Exception:  # noqa: BLE001
                detail = ""
            raise RuntimeError(
                f"{method} {path} failed ({e.code}): {detail}") from e

    def submit_job(self, *, entrypoint: str, runtime_env: dict | None =
                   None, submission_id: str | None = None,
                   metadata: dict | None = None) -> str:
        reply = self._request("POST", "/api/jobs", {
            "entrypoint": entrypoint, "runtime_env": runtime_env,
            "submission_id": submission_id, "metadata": metadata})
        return reply["submission_id"]

    def list_jobs(self) -> list[dict]:
        return self._request("GET", "/api/jobs")

    def get_job_info(self, job_id: str) -> dict:
        return self._request("GET", f"/api/jobs/{job_id}")

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_logs(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def stop_job(self, job_id: str) -> bool:
        return self._request("POST", f"/api/jobs/{job_id}/stop")["stopped"]

    def wait_until_finished(self, job_id: str, timeout: float = 120.0,
                            poll_s: float = 0.5) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still "
                           f"{self.get_job_status(job_id)} after "
                           f"{timeout}s")
