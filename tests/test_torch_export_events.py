"""The port's export events (``_private/export_events.py``, the GCS's
hooks, ``ExportEventsGet`` and the dashboard's ``/api/export_events``)
against the JAX package's: tests/test_export_events.py's three cases
(rotation and reads, ids made JSON, a live session's lifecycle events
on disk and through the GCS) and the dashboard route, run through both
packages with equal outcomes.

One cluster per package for the module, both with the dashboard on and
task events exported (``export_task_events``, off by default)."""

from __future__ import annotations

import glob
import importlib
import json
import os
import time
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
_SETTINGS = {"ART_INCLUDE_DASHBOARD": "1", "ART_EXPORT_TASK_EVENTS": "1"}
WANT_KINDS = {("EXPORT_NODE", "ALIVE"), ("EXPORT_DRIVER_JOB", "STARTED"),
              ("EXPORT_ACTOR", "ALIVE"), ("EXPORT_ACTOR", "DEAD"),
              ("EXPORT_PLACEMENT_GROUP", "PENDING"),
              ("EXPORT_PLACEMENT_GROUP", "REMOVED"),
              ("EXPORT_TASK", "FINISHED")}


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _each(scenario):
    got = [scenario(art) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def test_recorder_rotation_and_read(tmp_path):
    def scenario(art):
        root = tmp_path / art.__name__
        rec = _mod(art, "_private.export_events").ExportEventRecorder(
            str(root), max_file_bytes=2048)
        for i in range(100):
            rec.record("EXPORT_TASK", "FINISHED", f"t{i}",
                       {"pad": "x" * 64})
        rec.flush()          # writes happen on the recorder's own thread
        path = os.path.join(str(root), "event_EXPORT_TASK.log")
        events = rec.read("EXPORT_TASK", limit=10)
        return (os.path.exists(path), os.path.exists(path + ".1"),
                os.path.getsize(path) <= 2048 + 256, len(events),
                events[-1]["entity_id"], events[0]["seq"] < events[-1]["seq"],
                sorted(events[-1]))

    out = _each(scenario)
    assert out[:6] == (True, True, True, 10, "t99", True)


def test_recorder_jsonable_ids(tmp_path):
    def scenario(art):
        nid_cls = _mod(art, "_private.ids").NodeID
        rec = _mod(art, "_private.export_events").ExportEventRecorder(
            str(tmp_path / art.__name__))
        nid = nid_cls(b"\x07" * nid_cls.SIZE)
        rec.record("EXPORT_NODE", "ALIVE", nid, {"node_id": nid,
                                                 "labels": {"a": 1}})
        event = rec.read("EXPORT_NODE")[-1]
        return (event["entity_id"] == nid.hex(),
                event["data"]["node_id"] == nid.hex(),
                event["data"]["labels"])

    assert _each(scenario) == (True, True, {"a": 1})


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
            out[art] = {"url": ctx.dashboard_url,
                        "rt": _mod(art, "_private.worker")
                        .global_worker.runtime}
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


def _lifecycle(art):
    @art.remote
    def f():
        return 1

    assert art.get(f.remote()) == 1

    @art.remote
    class A:
        def ping(self):
            return "pong"

    actor = A.remote()
    assert art.get(actor.ping.remote()) == "pong"
    art.kill(actor)
    pg_mod = _mod(art, "util.placement_group")
    pg = pg_mod.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    pg_mod.remove_placement_group(pg)


def test_cluster_lifecycle_events_exported(clusters):
    """A live session exports node/job/actor/PG/task lifecycle events as
    JSONL under the session dir, queryable through the GCS."""
    def scenario(art):
        rt = clusters[art]["rt"]
        _lifecycle(art)
        gcs = _mod(art, "_private.protocol").ClientPool().get(
            rt.gcs_address)
        deadline = time.monotonic() + 15
        while True:
            reply = gcs.call("ExportEventsGet", {"limit": 5000},
                             timeout=10)
            kinds = {(e["source_type"], e["event_type"])
                     for e in reply["events"]}
            if WANT_KINDS <= kinds or time.monotonic() > deadline:
                break
            time.sleep(0.3)
        files = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(rt.session_dir, "export_events", "event_*.log")))
        return reply["enabled"], sorted(WANT_KINDS - kinds), files

    enabled, missing, files = _each(scenario)
    assert enabled and not missing
    assert "event_EXPORT_ACTOR.log" in files


def test_export_events_route(clusters):
    """``/api/export_events`` and its ``source_type`` and ``limit``
    filters."""
    def scenario(art):
        url = clusters[art]["url"] + "/api/export_events"
        with urllib.request.urlopen(url, timeout=30) as resp:
            every = json.loads(resp.read().decode())
        with urllib.request.urlopen(
                url + "?source_type=EXPORT_NODE&limit=1",
                timeout=30) as resp:
            nodes = json.loads(resp.read().decode())
        return (sorted(every), every["enabled"],
                bool(every["events"]),
                sorted(every["events"][0]) if every["events"] else None,
                len(nodes["events"]),
                [e["source_type"] for e in nodes["events"]],
                [e["event_type"] for e in nodes["events"]])

    assert _each(scenario) == (["enabled", "events"], True, True,
                               ["data", "entity_id", "event_type", "seq",
                                "source_type", "timestamp"],
                               1, ["EXPORT_NODE"], ["ALIVE"])
