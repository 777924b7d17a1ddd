"""Export-event pipeline: durable JSONL lifecycle events for external
consumers (ref: the reference's RayEventRecorder + export_*.proto event
schemas written for off-cluster pipelines — actor / node / job /
placement-group / task definition and lifecycle events).

Events append to one file per source type under the session's export
dir (``event_EXPORT_ACTOR.log`` etc.), newest-last, with a single
size-based rotation (``.1`` backup) so a chatty cluster can't fill the
disk.  The format is self-describing JSON — no proto toolchain needed
to consume it.

Writes happen on a dedicated writer thread (the recorder is called from
the GCS event loop — per-event file I/O there would stall heartbeats
and lease RPCs); ``record()`` only enqueues.  ``read()`` drains the
queue first so readers see their own writes.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time

SOURCE_TYPES = ("EXPORT_ACTOR", "EXPORT_NODE", "EXPORT_JOB",
                "EXPORT_PLACEMENT_GROUP", "EXPORT_TASK",
                "EXPORT_DRIVER_JOB", "EXPORT_WORKER")


def _to_jsonable(value):
    """IDs and bytes → hex/str so events stay plain JSON."""
    if isinstance(value, dict):
        return {str(_to_jsonable(k)): _to_jsonable(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, (bytes, bytearray)):
        return value.hex()
    if hasattr(value, "hex") and not isinstance(value, (int, float)):
        try:
            return value.hex()
        except Exception:  # noqa: BLE001
            return str(value)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


class ExportEventRecorder:
    """Append-only JSONL event writer with per-source rotation and an
    off-loop writer thread."""

    def __init__(self, export_dir: str,
                 max_file_bytes: int = 16 * 1024 * 1024):
        self._dir = export_dir
        self._max = max_file_bytes
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue(maxsize=100000)
        self._files: dict[str, object] = {}   # source -> open handle
        self._sizes: dict[str, int] = {}
        os.makedirs(export_dir, exist_ok=True)
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="export-events-writer")
        self._writer.start()

    def _path(self, source_type: str) -> str:
        return os.path.join(self._dir, f"event_{source_type}.log")

    def record(self, source_type: str, event_type: str,
               entity_id, data: dict | None = None) -> None:
        """Enqueue one event; never raises and never touches the disk
        on the caller's thread (export is observability, not control
        flow)."""
        try:
            with self._seq_lock:
                self._seq += 1
                seq = self._seq
            event = {"seq": seq,
                     "timestamp": time.time(),
                     "source_type": source_type,
                     "event_type": event_type,
                     "entity_id": _to_jsonable(entity_id),
                     "data": _to_jsonable(data or {})}
            self._queue.put_nowait(event)
        except Exception:  # noqa: BLE001 — full queue drops, never breaks
            pass

    def _drain(self) -> None:
        while True:
            event = self._queue.get()
            try:
                self._write(event)
            except Exception:  # noqa: BLE001 — disk full etc.
                pass
            finally:
                self._queue.task_done()

    def _handle(self, source_type: str):
        f = self._files.get(source_type)
        if f is None:
            path = self._path(source_type)
            f = open(path, "a")
            self._files[source_type] = f
            try:
                self._sizes[source_type] = os.path.getsize(path)
            except OSError:
                self._sizes[source_type] = 0
        return f

    def _write(self, event: dict) -> None:
        source = event["source_type"]
        line = json.dumps(event, separators=(",", ":")) + "\n"
        if self._sizes.get(source, 0) + len(line) > self._max:
            f = self._files.pop(source, None)
            if f is not None:
                f.close()
            path = self._path(source)
            try:
                os.replace(path, path + ".1")
            except OSError:
                pass
            self._sizes[source] = 0
        f = self._handle(source)
        f.write(line)
        f.flush()
        self._sizes[source] = self._sizes.get(source, 0) + len(line)

    def flush(self, timeout: float = 5.0) -> None:
        """Block until every enqueued event hit the disk (bounded)."""
        deadline = time.monotonic() + timeout
        while not self._queue.empty() or self._queue.unfinished_tasks:
            if time.monotonic() > deadline:
                return
            time.sleep(0.01)

    def read(self, source_type: str | None = None,
             limit: int = 1000) -> list[dict]:
        """Newest-last events, optionally filtered by source type (the
        dashboard's /api/export_events and tests read through this).
        Call off the event loop — this parses files."""
        self.flush()
        sources = [source_type] if source_type else list(SOURCE_TYPES)
        out: list[dict] = []
        for src in sources:
            path = self._path(src)
            for candidate in (path + ".1", path):
                try:
                    with open(candidate) as f:
                        for line in f:
                            try:
                                out.append(json.loads(line))
                            except ValueError:
                                continue
                except OSError:
                    continue
        # Order by wall time first: seq restarts at 1 when a head
        # restarts into the same (append-mode) files, so seq alone
        # would rank the previous run's events as newest forever.
        out.sort(key=lambda e: (e.get("timestamp", 0), e.get("seq", 0)))
        return out[-limit:]
