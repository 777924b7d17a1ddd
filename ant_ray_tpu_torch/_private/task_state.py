"""GCS-side task state aggregation: the bounded per-(task, attempt)
state table behind the ``ListTasks`` / ``GetTask`` / ``SummarizeTasks``
state API (ref: GcsTaskManager, src/ray/gcs/gcs_task_manager.h:97 —
the reference folds core-worker task events into a bounded, GC'd task
table at ingestion so state queries never replay the raw event ring).

Design constraints, in order:

* **Ingest stays cheap.**  ``apply()`` runs once per event on the GCS
  io loop, inline with ``TaskEventsAdd`` (the comment in gcs.py's
  handler pins why: recording per-event work costs double-digit
  percentages of async task throughput on a small head).  The fold is
  a dict upsert plus a few assignments — no sorting, no allocation
  beyond the record dict, benched by ``task_state_ingest_overhead_ns``.
* **Out-of-order tolerant, forward-only.**  Flush batches from
  different processes interleave arbitrarily: the driver's
  ``submitted`` routinely lands after the worker's ``finished``.  A
  record's state only moves FORWARD through the rank below, terminal
  states are sticky (equal-rank arrivals never overwrite — a late
  ``finished`` flush cannot erase ``FAILED``), and per-state
  timestamps are kept regardless of arrival order so durations stay
  right.
* **Attempts are first-class.**  Records key by ``(task_id, attempt)``
  — a retry's ``started`` must not erase attempt 0's terminal state
  (the client-side fold bug this table replaces).
* **Bounded.**  Per-job cap (``task_table_max_per_job``) with
  evict-finished-first GC (ref: the gcs_task_manager.h:60 policy);
  evictions are counted and surfaced as ``num_tasks_dropped`` so a
  clipped view is never mistaken for a complete one.
"""

from __future__ import annotations

import time

# State ranks: a record only ever moves to a STRICTLY higher rank.
# FINISHED and FAILED share the terminal rank — whichever lands first
# wins, so a late duplicate flush cannot flip a failure to success.
PENDING = "PENDING"
PENDING_EXECUTION = "PENDING_EXECUTION"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"

STATE_RANK = {PENDING: 0, PENDING_EXECUTION: 1, RUNNING: 2,
              FINISHED: 3, FAILED: 3}
TERMINAL_STATES = (FINISHED, FAILED)

_EVENT_STATE = {"submitted": PENDING_EXECUTION, "started": RUNNING,
                "finished": FINISHED, "failed": FAILED}
# Wall-clock timestamp slot each event fills (events carry the
# producer's time.time(); cross-process wall clocks are the wire
# convention for these, same as deadline_ts).
_EVENT_TS_KEY = {"submitted": "submitted_ts", "started": "started_ts",
                 "finished": "end_ts", "failed": "end_ts"}


class TaskStateTable:
    """Single-threaded fold of task lifecycle events into per-attempt
    state records (GCS io-loop use: no locks, like the other tables)."""

    def __init__(self, max_per_job: int | None = None):
        # (task_id, attempt) -> record dict.  Insertion-ordered: GC
        # walks oldest-first within its eviction class.
        self._records: dict[tuple[str, int], dict] = {}
        self._by_job: dict[str, int] = {}      # job_id -> live records
        self._dropped_by_job: dict[str, int] = {}
        self._seq = 0              # monotone insert counter (pagination)
        self._max_per_job = max_per_job
        self.num_tasks_dropped = 0   # GC evictions (view clipped)
        self.events_folded = 0

    # ------------------------------------------------------------ ingest

    def _cap(self) -> int:
        if self._max_per_job is not None:
            return self._max_per_job
        from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

        return global_config().task_table_max_per_job

    def apply(self, event: dict) -> None:
        """Fold one lifecycle event (hot path — see module docstring)."""
        state = _EVENT_STATE.get(event.get("event"))
        if state is None:
            return
        self.events_folded += 1
        key = (event["task_id"], int(event.get("attempt") or 0))
        record = self._records.get(key)
        if record is None:
            job_id = event.get("job_id") or ""
            self._seq += 1
            record = {
                "task_id": key[0], "attempt": key[1],
                "name": event.get("name", ""),
                "state": PENDING, "job_id": job_id,
                "actor_id": event.get("actor_id"),
                "parent_task_id": event.get("parent_task_id"),
                "node_id": "", "pid": event.get("pid"),
                "error": None, "trace_id": None,
                "submitted_ts": None, "started_ts": None, "end_ts": None,
                "_seq": self._seq,
            }
            self._records[key] = record
            self._by_job[job_id] = self._by_job.get(job_id, 0) + 1
            if self._by_job[job_id] > self._cap():
                self._gc_job(job_id)
        # Per-state timestamps land regardless of arrival order (a
        # late `submitted` still fills submitted_ts under a FINISHED
        # record, keeping queue-time attribution right).
        ts_key = _EVENT_TS_KEY[event["event"]]
        if record[ts_key] is None:
            record[ts_key] = event.get("ts")
        # Identity fields: fill what this event knows and the record
        # doesn't (the driver's `submitted` carries the parent link,
        # the worker's `started` carries the node).
        if event.get("event") == "started" and event.get("node_id"):
            record["node_id"] = event["node_id"]
        if record["actor_id"] is None and event.get("actor_id"):
            record["actor_id"] = event["actor_id"]
        if record["parent_task_id"] is None and \
                event.get("parent_task_id"):
            record["parent_task_id"] = event["parent_task_id"]
        if not record["job_id"] and event.get("job_id"):
            self._reindex_job(record, event["job_id"])
        if event.get("trace_id"):
            record["trace_id"] = event["trace_id"]
        if event.get("error") and record["error"] is None:
            record["error"] = str(event["error"])[:512]
        # Forward-only state machine: strictly-higher rank moves the
        # state; terminal states are sticky against equal-rank
        # duplicates (FAILED never becomes FINISHED).
        if STATE_RANK[state] > STATE_RANK[record["state"]]:
            record["state"] = state

    def _reindex_job(self, record: dict, job_id: str) -> None:
        """A later event learned the record's job — move the per-job
        accounting off the anonymous bucket."""
        old = record["job_id"]
        self._by_job[old] = self._by_job.get(old, 1) - 1
        if self._by_job.get(old, 0) <= 0:
            self._by_job.pop(old, None)
        record["job_id"] = job_id
        self._by_job[job_id] = self._by_job.get(job_id, 0) + 1
        if self._by_job[job_id] > self._cap():
            self._gc_job(job_id)

    def _gc_job(self, job_id: str) -> None:
        """Evict the job back under its cap: finished attempts first
        (oldest first), then the oldest records of any state — live
        work is the last thing an operator loses sight of."""
        cap = self._cap()
        excess = self._by_job.get(job_id, 0) - cap
        if excess <= 0:
            return
        doomed = []
        for key, record in self._records.items():   # insertion order
            if record["job_id"] != job_id:
                continue
            if record["state"] in TERMINAL_STATES:
                doomed.append(key)
                if len(doomed) >= excess:
                    break
        if len(doomed) < excess:
            have = set(doomed)
            for key, record in self._records.items():
                if record["job_id"] != job_id or key in have:
                    continue
                doomed.append(key)
                if len(doomed) >= excess:
                    break
        for key in doomed:
            del self._records[key]
        self._by_job[job_id] = self._by_job.get(job_id, 0) - len(doomed)
        self._dropped_by_job[job_id] = \
            self._dropped_by_job.get(job_id, 0) + len(doomed)
        self.num_tasks_dropped += len(doomed)

    # ------------------------------------------------------------- reads

    @staticmethod
    def _durations(record: dict) -> dict:
        """Per-stage durations derivable from the filled timestamps
        (None when the bracketing events haven't both arrived)."""
        sub, start, end = (record["submitted_ts"], record["started_ts"],
                           record["end_ts"])
        return {
            "queue_s": (start - sub
                        if sub is not None and start is not None
                        else None),
            "run_s": (end - start
                      if start is not None and end is not None
                      else None),
            "total_s": (end - sub
                        if sub is not None and end is not None
                        else None),
        }

    def _public(self, record: dict) -> dict:
        out = {k: v for k, v in record.items() if k != "_seq"}
        out.update(self._durations(record))
        return out

    @staticmethod
    def _matches(record: dict, filters: dict) -> bool:
        state = filters.get("state")
        if state and record["state"] != state:
            return False
        name = filters.get("name")
        if name and record["name"] != name:
            return False
        job_id = filters.get("job_id")
        if job_id and record["job_id"] != job_id:
            return False
        actor_id = filters.get("actor_id")
        if actor_id and record["actor_id"] != actor_id:
            return False
        node_id = filters.get("node_id")
        if node_id and not record["node_id"].startswith(node_id):
            return False
        return True

    def list(self, filters: dict | None = None, limit: int = 1000,
             token: int | None = None) -> dict:
        """Filtered page of records in insertion order.  ``token`` is
        the opaque continuation cursor from the previous page (the last
        record's insert seq — eviction-safe: GC'd records simply no
        longer appear, never shifting the cursor)."""
        filters = filters or {}
        limit = max(1, int(limit))
        after = int(token or 0)
        out: list[dict] = []
        last_seq = after
        next_token = None
        for record in self._records.values():
            if record["_seq"] <= after or \
                    not self._matches(record, filters):
                continue
            if len(out) >= limit:
                # Another match exists past the page — there IS a next
                # page, resumable after the last record we returned.
                next_token = last_seq
                break
            out.append(self._public(record))
            last_seq = record["_seq"]
        return {"tasks": out, "next_token": next_token,
                "num_tasks_dropped": self.num_tasks_dropped}

    def get(self, task_id: str) -> list[dict]:
        """Every attempt of one task, attempt-ordered."""
        return sorted(
            (self._public(r) for (tid, _a), r in self._records.items()
             if tid == task_id),
            key=lambda r: r["attempt"])

    def summarize(self, filters: dict | None = None) -> dict:
        """Group-by-name rollup: per-state counts plus run-duration
        stats (mean/p50/p99 over attempts with a measured run_s),
        computed here so the client never pulls the table.  ONE rollup
        implementation: delegates to :func:`summarize_public_records`,
        which the HA cross-replica merge path uses too."""
        filters = filters or {}
        reply = summarize_public_records(
            self._public(r) for r in self._records.values()
            if self._matches(r, filters))
        reply["num_tasks_dropped"] = self.num_tasks_dropped
        return reply

    def stats(self) -> dict:
        return {
            "num_records": len(self._records),
            "num_tasks_dropped": self.num_tasks_dropped,
            "events_folded": self.events_folded,
            "dropped_by_job": dict(self._dropped_by_job),
        }


# ------------------------------------------------ cross-replica merge
# (GCS HA: the task-event ring is sharded across replicas by producer —
#  ListTasks/GetTask/SummarizeTasks on any replica fan out local_only
#  queries and merge HERE, with the same forward-only / sticky-terminal
#  rules as apply(), so a task whose events landed on two replicas
#  still reads as one record and FAILED can never un-happen.)

_MERGE_FILL_NONE = ("submitted_ts", "started_ts", "end_ts", "actor_id",
                    "parent_task_id", "trace_id", "error", "pid")
_MERGE_FILL_EMPTY = ("name", "job_id", "node_id")


def merge_public_records(record_lists) -> list[dict]:
    """Merge per-replica public task records (as returned by
    :meth:`TaskStateTable.list`) keyed by ``(task_id, attempt)``.
    State moves by strictly-greater rank (terminal sticky), missing
    timestamps/identity fields fill from whichever replica knows them,
    and durations are recomputed from the merged timestamps."""
    out: dict[tuple, dict] = {}
    for records in record_lists:
        for rec in records or ():
            key = (rec["task_id"], rec["attempt"])
            cur = out.get(key)
            if cur is None:
                out[key] = dict(rec)
                continue
            for field in _MERGE_FILL_NONE:
                if cur.get(field) is None and rec.get(field) is not None:
                    cur[field] = rec[field]
            for field in _MERGE_FILL_EMPTY:
                if not cur.get(field) and rec.get(field):
                    cur[field] = rec[field]
            if STATE_RANK[rec["state"]] > STATE_RANK[cur["state"]]:
                cur["state"] = rec["state"]
    merged = list(out.values())
    for rec in merged:
        rec.update(TaskStateTable._durations(rec))
    # Deterministic order so offset-style continuation over the merged
    # view walks each record exactly once.
    merged.sort(key=lambda r: (r.get("submitted_ts")
                               or r.get("started_ts")
                               or r.get("end_ts") or 0.0,
                               r["task_id"], r["attempt"]))
    return merged


def summarize_public_records(records) -> dict:
    """:meth:`TaskStateTable.summarize` semantics over (merged) public
    records — the rollup a replica computes after the HA fan-in."""
    groups: dict[str, dict] = {}
    durations: dict[str, list[float]] = {}
    for record in records:
        name = record["name"]
        group = groups.get(name)
        if group is None:
            group = groups[name] = {
                "state_counts": {}, "total": 0, "failed": 0}
            durations[name] = []
        group["total"] += 1
        counts = group["state_counts"]
        counts[record["state"]] = counts.get(record["state"], 0) + 1
        if record["state"] == FAILED:
            group["failed"] += 1
        if record.get("run_s") is not None:
            durations[name].append(record["run_s"])
    for name, group in groups.items():
        runs = sorted(durations[name])
        if runs:
            group["run_s"] = {
                "count": len(runs),
                "mean": sum(runs) / len(runs),
                "p50": runs[len(runs) // 2],
                "p99": runs[min(len(runs) - 1,
                                int(0.99 * (len(runs) - 1)))],
            }
        else:
            group["run_s"] = None
    return {"summary": groups,
            "total_tasks": sum(g["total"] for g in groups.values())}


def ingest_overhead_ns(n: int = 20000) -> float:
    """Per-event fold cost (the ``task_state_ingest_overhead_ns``
    microbench body lives with the table it measures): folds ``n``
    synthetic submit/start/finish triples through one table and
    reports ns per EVENT."""
    table = TaskStateTable(max_per_job=n * 4)
    base = time.time()
    events = []
    for i in range(n // 3):
        tid = f"t{i:08x}"
        events.append({"task_id": tid, "name": "bench", "job_id": "j",
                       "event": "submitted", "ts": base, "attempt": 0})
        events.append({"task_id": tid, "name": "bench", "job_id": "j",
                       "event": "started", "ts": base + 0.001,
                       "node_id": "n1", "attempt": 0})
        events.append({"task_id": tid, "name": "bench", "job_id": "j",
                       "event": "finished", "ts": base + 0.002,
                       "attempt": 0})
    t0 = time.perf_counter()
    apply = table.apply
    for event in events:
        apply(event)
    elapsed = time.perf_counter() - t0
    return elapsed / max(1, len(events)) * 1e9
