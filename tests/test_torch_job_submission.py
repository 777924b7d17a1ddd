"""The port's job submission (``job_submission/``, the dashboard's
``JobManager`` and its five ``/api/jobs*`` routes) against the JAX
package's: tests/test_ops.py's job cases (a driver submitted end to end,
a job stopped, a missing job), a duplicate ``submission_id``, and the
five routes' replies compared field by field, ids and times apart.

One cluster per package for the module, both with the dashboard on."""

from __future__ import annotations

import importlib
import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
_SETTINGS = {"ART_INCLUDE_DASHBOARD": "1"}
DRIVER = """\
import os
import {package} as art
art.init(address=os.environ['ART_ADDRESS'])
@art.remote
def f(x):
    return x * 2
print('RESULT', art.get(f.remote(21)), os.environ.get('JOB_FLAG'))
print('CWD', os.path.basename(os.getcwd()))
art.shutdown()
"""


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _mask(text: str) -> str:
    text = text.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", text)


@pytest.fixture(scope="module")
def clusters():
    prior = {k: os.environ.get(k) for k in _SETTINGS}
    os.environ.update(_SETTINGS)
    for art in PACKAGES:
        _mod(art, "_private.config")._global_config = None
    try:
        out = {}
        for art in PACKAGES:
            ctx = art.init(num_cpus=2)
            assert ctx.dashboard_url, "dashboard did not start"
            out[art] = ctx.dashboard_url
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


def _client(art, url):
    return _mod(art, "job_submission").JobSubmissionClient(url)


def _each(scenario):
    got = [scenario(art) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def _driver_dir(tmp_path, art):
    wd = tmp_path / art.__name__ / "jobdir"
    wd.mkdir(parents=True)
    (wd / "driver.py").write_text(DRIVER.format(package=art.__name__))
    return wd


def test_job_submission_end_to_end(clusters, tmp_path):
    def scenario(art):
        client = _client(art, clusters[art])
        job_id = client.submit_job(
            entrypoint="python driver.py",
            runtime_env={"working_dir": str(_driver_dir(tmp_path, art)),
                         "env_vars": {"JAX_PLATFORMS": "cpu",
                                      "JOB_FLAG": "seen"}})
        status = client.wait_until_finished(job_id, timeout=120)
        logs = client.get_job_logs(job_id)
        return (status, "RESULT 42 seen" in logs, "CWD jobdir" in logs,
                any(j["submission_id"] == job_id
                    for j in client.list_jobs()))

    status = _mod(jart, "job_submission").JobStatus.SUCCEEDED
    assert _each(scenario) == (status, True, True, True)


def test_job_stop_and_missing(clusters):
    def scenario(art):
        js = _mod(art, "job_submission")
        client = _client(art, clusters[art])
        job_id = client.submit_job(entrypoint="sleep 60")
        running = client.get_job_status(job_id)
        stopped = client.stop_job(job_id)
        status = client.wait_until_finished(job_id, timeout=30)
        again = client.stop_job(job_id)
        with pytest.raises(RuntimeError, match="404") as ei:
            client.get_job_info("nope")
        return (running == js.JobStatus.RUNNING, stopped,
                status == js.JobStatus.STOPPED, again, str(ei.value))

    assert _each(scenario) == (
        True, True, True, False,
        "GET /api/jobs/nope failed (404): no such job")


def test_duplicate_submission_id_is_refused(clusters):
    def scenario(art):
        client = _client(art, clusters[art])
        first = client.submit_job(entrypoint="true",
                                  submission_id="dup-job",
                                  metadata={"owner": "tests"})
        with pytest.raises(RuntimeError, match="409") as ei:
            client.submit_job(entrypoint="true", submission_id="dup-job")
        client.wait_until_finished(first, timeout=30)
        info = client.get_job_info(first)
        return first, str(ei.value), info["metadata"], info["status"]

    assert _each(scenario) == (
        "dup-job", "POST /api/jobs failed (409): job dup-job already exists",
        {"owner": "tests"}, "SUCCEEDED")


def _http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _fields(reply):
    """A reply with ids and times masked: key by key, the values a
    second run of the same request would repeat."""
    if isinstance(reply, dict):
        return {k: ("<time>" if k.endswith("_time") and v is not None
                    else _fields(v)) for k, v in sorted(reply.items())}
    if isinstance(reply, (list, tuple)):
        return type(reply)(_fields(v) for v in reply)
    if isinstance(reply, str):
        return _mask(re.sub(r"art-job-[0-9a-f]+", "art-job-<id>", reply))
    return reply


def test_the_five_routes_reply_alike(clusters):
    """POST /api/jobs, GET /api/jobs, GET /api/jobs/{id}, GET
    /api/jobs/{id}/logs and POST /api/jobs/{id}/stop (and their error
    replies) field by field."""
    def scenario(art):
        base = clusters[art] + "/api/jobs"
        replies = {"missing_entrypoint": _http("POST", base, {})}
        status, sub = _http("POST", base, {
            "entrypoint": "echo routed-$ROUTE_FLAG && sleep 60",
            "runtime_env": {"env_vars": {"ROUTE_FLAG": "yes"}},
            "metadata": {"k": "v"}})
        replies["submit"] = (status, sub)
        job_id = sub["submission_id"]
        client = _client(art, clusters[art])
        t_end = time.monotonic() + 30
        while "routed-yes" not in client.get_job_logs(job_id) and \
                time.monotonic() < t_end:
            time.sleep(0.1)
        replies["get"] = _http("GET", f"{base}/{job_id}")
        replies["logs"] = _http("GET", f"{base}/{job_id}/logs")
        replies["stop"] = _http("POST", f"{base}/{job_id}/stop")
        client.wait_until_finished(job_id, timeout=30)
        replies["get_after"] = _http("GET", f"{base}/{job_id}")
        replies["stop_again"] = _http("POST", f"{base}/{job_id}/stop")
        replies["list"] = (lambda s, r: (s, [j for j in r
                                             if j["submission_id"]
                                             == job_id]))(
            *_http("GET", base))
        replies["get_missing"] = _http("GET", f"{base}/nope")
        replies["logs_missing"] = _http("GET", f"{base}/nope/logs")
        replies["stop_missing"] = _http("POST", f"{base}/nope/stop")
        return _fields(replies)

    out = _each(scenario)
    assert out["submit"] == (200, {"submission_id": "art-job-<id>"})
    assert out["get_after"][1]["status"] == "STOPPED"
    assert out["logs"][1] == {"logs": "routed-yes\n"}
