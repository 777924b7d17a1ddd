"""Task event buffer: per-process buffering of task lifecycle events,
flushed in batches to the GCS aggregator.

Mirror of the reference's TaskEventBuffer (ref:
src/ray/core_worker/task_event_buffer.h — workers buffer status-change
events and periodically flush to the GCS task-event aggregator; the
timeline / state API read the aggregate).  The record() hot path
buffers compact tuples; flush expands them into the wire dicts (once
per batch, off the per-call path):

    {"task_id", "name", "event", "ts", "pid", "node_id", "worker",
     "parent_task_id", "actor_id", "attempt", "job_id", "error?",
     "trace_id?"}

``event`` ∈ {submitted, started, finished, failed}.  Flushes ride one
oneway RPC per batch (size- or age-triggered from the record path plus
an atexit drain — no dedicated thread on the hot path).  The executing
task's id is kept in a contextvar so nested submissions record their
parent, giving the timeline its span tree without a full OTel stack.

Loss accounting: a batch whose send raises is requeued ONCE (bounded —
the buffer must not grow without limit against a dead GCS); a batch
that fails twice is dropped and counted, and the drop count rides the
next successful flush (``dropped`` payload key) into the GCS
``task_events_dropped`` stat the state API reports — a lossy task view
is visible, never silent.
"""

from __future__ import annotations

import atexit
import contextvars
import os
import threading
import time

_MAX_BUFFER = 512
# A failed batch is requeued once if it fits this bound; combined with
# _MAX_BUFFER the buffer holds at most 2 batches against a dead GCS.
_MAX_REQUEUE = _MAX_BUFFER
_FLUSH_AGE_S = 1.0
# Terminal events (finished/failed) kept for replay after a GCS-replica
# failover: the replica that ingested them may die with its ring, and a
# FAILED that un-happens is the one loss the state API must never show.
# Bounded — only the recent tail replays; dedup is the state table's
# sticky-terminal fold.
_TERMINAL_TAIL = 256

current_task = contextvars.ContextVar("art_current_task", default=None)

# Per-process constants, hoisted off the record() hot path.
_PID = os.getpid()
_NODE_ID = os.environ.get("ART_NODE_ID", "")


class TaskEventBuffer:
    def __init__(self):
        self._events: list[dict] = []
        from ant_ray_tpu_torch._lint.lockcheck import make_lock  # noqa: PLC0415

        self._lock = make_lock("task_events.buffer")
        self._last_flush = time.monotonic()
        self._registered = False
        self._atexit_registered = False
        self._flusher: threading.Thread | None = None
        self._retry: list[dict] | None = None  # one requeued batch
        self.dropped_total = 0                 # lifetime local drops
        self._dropped_unreported = 0           # delta not yet at the GCS
        from collections import deque  # noqa: PLC0415

        # Recent terminal events + the GCS ring epoch they were last
        # published under (see module constant).  When the router's
        # ring epoch moves (replica died / set changed), the next flush
        # prepends this tail so terminal states survive the failover.
        self._terminal_tail: deque = deque(maxlen=_TERMINAL_TAIL)
        self._ring_epoch_seen = 0

    def record(self, runtime, *, task_id: str, name: str, event: str,
               actor_id: str | None = None,
               parent_task_id: str | None = None,
               attempt: int = 0, error: str | None = None) -> None:
        # Hot path: the buffer holds compact TUPLES; the wire dicts are
        # built at flush time (amortized once per batch).  This runs 3x
        # per task cluster-wide — a 13-key dict literal per event is
        # measurable control-plane tax at 10k calls/s.
        job_id = getattr(runtime, "job_id", None)
        ctx = _trace_current_sampled()
        entry = (
            task_id, name, event, time.time(),
            getattr(runtime, "address", ""), actor_id,
            parent_task_id or current_task.get(),
            # Execution attempt: lets span derivation salt ids so a
            # retried task's spans never collide with the original run.
            attempt,
            # Job membership: the GCS state table's GC policy is
            # per-job, and ListTasks filters on it.
            job_id.hex() if job_id is not None else None,
            error[:512] if error is not None else None,
            # Sampled requests link their task records to the trace —
            # `art trace <id>` and GetTask meet in the middle.
            ctx.trace_id if ctx is not None else None,
        )
        flush_now = False
        register = False
        with self._lock:
            self._events.append(entry)
            if event == "finished" or event == "failed":
                self._terminal_tail.append(entry)
            now = time.monotonic()
            if len(self._events) >= _MAX_BUFFER or \
                    now - self._last_flush > _FLUSH_AGE_S:
                flush_now = True
            if not self._registered:  # decide under the lock — two
                self._registered = True  # first-recording threads must
                register = True          # not double-start the flusher
        if flush_now:
            self.flush()
        if register:
            if not self._atexit_registered:
                self._atexit_registered = True
                atexit.register(self.flush)
            # Periodic flusher: without it, the last events of a
            # long-lived worker (e.g. "finished" for its final task)
            # would sit buffered until the next record or process exit.
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name="art-task-events")
            self._flusher.start()

    def _flush_loop(self) -> None:
        while True:
            time.sleep(_FLUSH_AGE_S)
            if _runtime() is None:
                # Worker disconnected (or events disabled): exit
                # instead of spinning no-op forever.  Clearing
                # _registered lets the next record() — e.g. after
                # art.shutdown()/art.init() — start a fresh flusher.
                with self._lock:
                    self._registered = False
                    self._flusher = None
                return
            self.flush()

    @staticmethod
    def _expand(entry) -> dict:
        """Compact buffer tuple -> the wire/GCS event dict (requeued
        batches are already expanded and pass through)."""
        if isinstance(entry, dict):
            return entry
        (task_id, name, event, ts, worker, actor_id, parent, attempt,
         job_id, error, trace_id) = entry
        out = {
            "task_id": task_id, "name": name, "event": event,
            "ts": ts, "pid": _PID, "node_id": _NODE_ID,
            "worker": worker, "actor_id": actor_id,
            "parent_task_id": parent, "attempt": attempt,
            "job_id": job_id,
        }
        if error is not None:
            out["error"] = error
        if trace_id is not None:
            out["trace_id"] = trace_id
        return out

    def flush(self) -> None:
        # The runtime is resolved per flush — a captured one would
        # outlive art.shutdown()/art.init() and drain this shared
        # buffer into the previous cluster's dead GCS.
        runtime = _runtime()
        if runtime is None:
            return
        # Ring-failover replay: the GCS router bumps ring_epoch when
        # the replica set changes (a replica died — possibly with this
        # producer's ingested events in its ring).  Replaying the
        # terminal tail costs one bounded batch; the GCS fold dedups.
        epoch = getattr(
            getattr(runtime, "_gcs", None), "ring_epoch", 0)
        replay: list[dict] = []
        prev_epoch_seen = None
        with self._lock:
            if epoch != self._ring_epoch_seen:
                prev_epoch_seen = self._ring_epoch_seen
                self._ring_epoch_seen = epoch
                replay = list(self._terminal_tail)
            if not self._events and self._retry is None \
                    and not self._dropped_unreported and not replay:
                return
            batch, self._events = self._events, []
            retry, self._retry = self._retry, None
            # Pop-and-zero under the lock: a concurrent flush (flusher
            # thread + a record()-triggered one) must not read the same
            # delta and double-report it to the GCS.
            dropped, self._dropped_unreported = \
                self._dropped_unreported, 0
            self._last_flush = time.monotonic()
        expand = self._expand
        batch = [expand(e) for e in batch]
        payload = {"events": [expand(e) for e in replay]
                   + (retry or []) + batch}
        if dropped:
            payload["dropped"] = dropped
        try:
            if replay:
                # A replay batch is the durability mechanism itself —
                # send it ACKNOWLEDGED (bounded timeout) rather than
                # fire-and-forget: a oneway's failure is swallowed
                # inside the async send, which would mark the epoch
                # seen while the tail never landed.  Failure lands in
                # the except below, which rewinds the epoch mark.
                call = getattr(getattr(runtime, "_gcs", None),
                               "call", None)
                if call is not None:
                    call("TaskEventsAdd", payload, timeout=2)
                else:        # bare fake/legacy runtime: best effort
                    runtime._send_oneway(runtime.gcs_address,
                                         "TaskEventsAdd", payload)
            else:
                runtime._send_oneway(runtime.gcs_address,
                                     "TaskEventsAdd", payload)
        except Exception:  # noqa: BLE001 — observability is best-effort
            with self._lock:
                # A replay that never left rewinds the epoch mark so
                # the next flush tries it again (the tail itself is
                # never consumed — it lives until overwritten).
                if prev_epoch_seen is not None:
                    self._ring_epoch_seen = prev_epoch_seen
                # The popped batch is NOT silently lost: requeue it
                # once under the bound; the already-retried part and
                # anything over the bound is dropped AND counted.
                newly_dropped = len(retry or [])
                if batch and len(batch) <= _MAX_REQUEUE \
                        and self._retry is None:
                    self._retry = batch
                else:
                    newly_dropped += len(batch)
                if newly_dropped:
                    self.dropped_total += newly_dropped
                    self._dropped_unreported += newly_dropped
                if dropped:   # the popped delta never reached the GCS
                    self._dropped_unreported += dropped


_buffer = TaskEventBuffer()


def _trace_current_sampled():
    """Lazy-bound (the tracing plane imports config, not this module):
    the first call replaces this indirection with the real accessor —
    record() runs 3x per task, and a per-call ``from ... import`` is
    measurable at 10k calls/s."""
    global _trace_current_sampled
    from ant_ray_tpu_torch.observability.tracing_plane import (  # noqa: PLC0415
        current_sampled,
    )

    _trace_current_sampled = current_sampled
    return current_sampled()


_get_config = _worker = None


def _runtime():
    # Same lazy-bind: resolve the accessors once (global_worker IS the
    # process singleton; the config OBJECT is swapped by api.init, so
    # only the accessor function may be cached).
    global _get_config, _worker
    if _get_config is None:
        from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        _get_config = global_config
        _worker = global_worker
    if not _get_config().enable_task_events:
        return None
    if not _worker.connected:
        return None
    runtime = _worker.runtime
    return runtime if hasattr(runtime, "_send_oneway") else None


def record(task_id: str, name: str, event: str, *,
           actor_id: str | None = None,
           parent_task_id: str | None = None,
           attempt: int = 0, error: str | None = None) -> None:
    runtime = _runtime()
    if runtime is None:
        return
    _buffer.record(runtime, task_id=task_id, name=name, event=event,
                   actor_id=actor_id, parent_task_id=parent_task_id,
                   attempt=attempt, error=error)


def flush() -> None:
    _buffer.flush()
