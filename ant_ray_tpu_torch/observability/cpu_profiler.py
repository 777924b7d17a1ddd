"""Continuous whole-cluster CPU profiling (ref model: Google-Wide
Profiling / Parca-style always-on sampling, scaled down to stdlib).

Every process class in a cluster — driver, node daemons, workers, GCS
replicas, node agents — runs one background sampler thread that walks
``sys._current_frames()`` at ``cpu_profile_hz`` (default 67 Hz, a prime
that avoids lockstep with 10/100 ms periodic work) and folds each
thread's stack into a bounded ``{folded_stack: count}`` dict keyed by
(process class, thread role, frames).  Folded means the classic
flamegraph.pl collapsed format: semicolon-joined root-first frames, one
counter per distinct stack — aggregation is O(depth) per thread per
tick, no per-sample allocation beyond the key string.

Publication is the step/span-events idiom: every
``cpu_profile_publish_period_s`` the sampler ships the DELTA since its
last publish to the GCS ``CpuProfileAdd`` ring, best-effort oneway
(dropped outside a cluster).  (The JAX package's replicated GCS keeps
a ring slice per replica and merges them at query time; GCS HA is
ROADMAP queue A item 6.6.)  The same publish tick
rolls up :mod:`protocol`'s wire-accounting counters into
``art_rpc_bytes_total{method,direction}`` /
``art_rpc_frames_total{method}`` counter deltas through ``MetricRecord``
— per-node control-plane cost as a scrapeable series.

Cost model: the sampler holds the GIL only inside one
``sys._current_frames()`` walk per tick; at 67 Hz with typical stack
depths the duty cycle stays under 2% of one core, and
``overhead_stats()`` reports the measured duty cycle and mean cost per
sample so the budget is checkable from inside any live process
(chip_smoke.py's ``operations`` phase holds the mean under 300 µs in
the driver and in an engine's worker on the card's host).
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

from ant_ray_tpu_torch._private.config import global_config

# Frames deeper than this are truncated (leaf side kept): runaway
# recursion must not turn one sample into an unbounded key.
_MAX_DEPTH = 48
# Per-publish cap on distinct stacks in one record; the remainder is
# folded into a "(truncated)" bucket so a publish can never exceed a
# few tens of KB on the wire.
_PUBLISH_TOP_N = 200

_OVERFLOW_KEY = "(overflow)"

# Trailing instance numbers collapse so thread ROLES stay low-
# cardinality: "art-executor-3" and "ThreadPoolExecutor-0_1" are the
# same role as their siblings.
_ROLE_SUFFIX = re.compile(r"[-_]\d+([-_]\d+)*$")


def _role(thread_name: str) -> str:
    return _ROLE_SUFFIX.sub("", thread_name) or thread_name


def _frame_label(frame) -> str:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}:{code.co_name}"


def _runtime():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if not global_worker.connected:
        return None
    runtime = global_worker.runtime
    if getattr(runtime, "_gcs", None) is None:
        return None  # local mode
    return runtime if hasattr(runtime, "_send_oneway") else None


def _default_publish(record: dict) -> None:
    """Drivers/workers ship through the runtime's oneway channel; other
    process classes install their own publisher at :func:`start`."""
    runtime = _runtime()
    if runtime is not None:
        runtime._send_oneway(runtime.gcs_address, "CpuProfileAdd",
                             {"records": [record]})


def _default_metric(payload: dict) -> None:
    runtime = _runtime()
    if runtime is not None:
        runtime._send_oneway(runtime.gcs_address, "MetricRecord", payload)


class CpuProfiler:
    """One process's always-on sampling profiler.

    The sampler thread owns all mutable state — counting, delta
    bookkeeping and publication all happen on it, so the hot path takes
    no lock.  Readers (``snapshot``/``overhead_stats``) only ever copy,
    which the GIL makes atomic.
    """

    def __init__(self, process_class: str, *, hz: float | None = None,
                 publish_period_s: float | None = None,
                 max_stacks: int | None = None,
                 publish_fn=None, metric_fn=None, node_id: str = ""):
        cfg = global_config()
        self.process_class = process_class
        self.hz = float(cfg.cpu_profile_hz if hz is None else hz)
        self.publish_period_s = float(
            cfg.cpu_profile_publish_period_s
            if publish_period_s is None else publish_period_s)
        self.max_stacks = int(cfg.cpu_profile_max_stacks
                              if max_stacks is None else max_stacks)
        self.publish_fn = publish_fn
        self.metric_fn = metric_fn
        self.node_id = (node_id or os.environ.get("ART_NODE_ID", ""))[:12]
        self._stacks: dict[str, int] = {}
        self._last_published: dict[str, int] = {}
        self._samples = 0
        self._published_samples = 0
        self._sample_cost_ns = 0
        self._started_monotonic = 0.0
        self._last_publish_ts = time.time()
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> "CpuProfiler":
        if self._thread is None:
            self._started_monotonic = time.monotonic()
            self._last_publish_ts = time.time()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="art-cpu-profiler")
            self._thread.start()
        return self

    def stop(self, *, final_publish: bool = True) -> None:
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None
        if final_publish:
            try:
                self._publish()
            except Exception:  # noqa: BLE001 — observability best-effort
                pass

    # -------------------------------------------------------- sampling

    def _run(self) -> None:
        interval = 1.0 / self.hz if self.hz > 0 else 1.0
        next_publish = time.monotonic() + self.publish_period_s
        while not self._stop_event.wait(interval):
            try:
                self._sample()
            except Exception:  # noqa: BLE001 — a torn-down interpreter
                return         # during exit must not spew tracebacks
            if time.monotonic() >= next_publish:
                next_publish = time.monotonic() + self.publish_period_s
                try:
                    self._publish()
                except Exception:  # noqa: BLE001 — best-effort
                    pass

    def _sample(self) -> None:
        t0 = time.perf_counter_ns()
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # never profile the profiler
            parts = []
            depth = 0
            while frame is not None and depth < _MAX_DEPTH:
                parts.append(_frame_label(frame))
                frame = frame.f_back
                depth += 1
            parts.reverse()
            role = _role(names.get(tid) or f"tid-{tid}")
            self._count(
                f"{self.process_class};{role};" + ";".join(parts))
        self._samples += 1
        self._sample_cost_ns += time.perf_counter_ns() - t0

    def _count(self, key: str, n: int = 1) -> None:
        stacks = self._stacks
        if key in stacks:
            stacks[key] += n
        elif len(stacks) < self.max_stacks:
            stacks[key] = n
        else:  # bounded: novel stacks collapse into one bucket
            overflow = f"{self.process_class};{_OVERFLOW_KEY}"
            stacks[overflow] = stacks.get(overflow, 0) + n

    # ----------------------------------------------------- publication

    def _publish(self) -> None:
        record = self._delta_record()
        if record is not None:
            publish = self.publish_fn or _default_publish
            try:
                publish(record)
            except Exception:  # noqa: BLE001 — best-effort
                pass
        try:
            self._publish_wire_metrics()
        except Exception:  # noqa: BLE001 — best-effort
            pass

    def _delta_record(self) -> dict | None:
        current = self._stacks.copy()
        delta: dict[str, int] = {}
        for key, count in current.items():
            d = count - self._last_published.get(key, 0)
            if d > 0:
                delta[key] = d
        self._last_published = current
        now = time.time()
        dur_s, self._last_publish_ts = now - self._last_publish_ts, now
        if not delta:
            return None
        if len(delta) > _PUBLISH_TOP_N:
            ranked = sorted(delta.items(), key=lambda kv: (-kv[1], kv[0]))
            kept = dict(ranked[:_PUBLISH_TOP_N])
            dropped = sum(delta.values()) - sum(kept.values())
            if dropped:
                truncated = f"{self.process_class};(truncated)"
                kept[truncated] = kept.get(truncated, 0) + dropped
            delta = kept
        total = self._samples
        samples = total - self._published_samples
        self._published_samples = total
        return {"node_id": self.node_id, "pid": os.getpid(),
                "proc": self.process_class, "ts": now, "dur_s": dur_s,
                "hz": self.hz, "samples": samples, "stacks": delta}

    def _publish_wire_metrics(self) -> None:
        from ant_ray_tpu_torch._private import protocol  # noqa: PLC0415

        deltas = protocol.wire_deltas()
        if not deltas:
            return
        metric = self.metric_fn or _default_metric
        node = self.node_id
        frames_by_method: dict[str, int] = {}
        for (method, direction), (frames, nbytes, encode_ns) in \
                deltas.items():
            frames_by_method[method] = \
                frames_by_method.get(method, 0) + frames
            if nbytes:
                metric({"name": "art_rpc_bytes_total", "type": "counter",
                        "value": float(nbytes),
                        "tags": {"method": method,
                                 "direction": direction,
                                 "node_id": node},
                        "description": "Wire bytes moved per RPC "
                                       "method and direction"})
            if encode_ns:
                metric({"name": "art_rpc_encode_seconds_total",
                        "type": "counter", "value": encode_ns / 1e9,
                        "tags": {"method": method, "node_id": node},
                        "description": "Client-side frame-encode time "
                                       "per RPC method"})
        for method, frames in frames_by_method.items():
            if frames:
                metric({"name": "art_rpc_frames_total",
                        "type": "counter", "value": float(frames),
                        "tags": {"method": method, "node_id": node},
                        "description": "Wire frames moved per RPC "
                                       "method"})
        for method, (calls, handle_ns) in \
                protocol.handle_deltas().items():
            if handle_ns:
                metric({"name": "art_rpc_handle_seconds_total",
                        "type": "counter", "value": handle_ns / 1e9,
                        "tags": {"method": method, "node_id": node},
                        "description": "Server-side dispatch-to-reply "
                                       "time per RPC method"})
            if calls:
                metric({"name": "art_rpc_handled_total",
                        "type": "counter", "value": float(calls),
                        "tags": {"method": method, "node_id": node},
                        "description": "Server-side dispatches per "
                                       "RPC method"})

    # --------------------------------------------------------- reading

    def snapshot(self) -> dict[str, int]:
        """Cumulative folded stacks since start (copy; GIL-atomic)."""
        return self._stacks.copy()

    def overhead_stats(self) -> dict:
        """Measured sampler duty cycle — the <2% budget, checkable live."""
        wall = max(time.monotonic() - self._started_monotonic, 1e-9)
        samples = max(self._samples, 1)
        cost_s = self._sample_cost_ns / 1e9
        return {"samples": self._samples,
                "avg_sample_cost_s": cost_s / samples,
                "overhead_fraction": cost_s / wall}


# -------------------------------------------------- process singleton

_profiler: CpuProfiler | None = None
_profiler_lock = threading.Lock()


def start(process_class: str, *, publish_fn=None, metric_fn=None,
          node_id: str = "", hz: float | None = None,
          publish_period_s: float | None = None) -> CpuProfiler | None:
    """Start this process's profiler (idempotent).  Returns None when
    ``cpu_profile_hz`` (or the explicit ``hz``) is 0 — the whole plane
    off-switch."""
    global _profiler
    effective_hz = global_config().cpu_profile_hz if hz is None else hz
    if effective_hz <= 0:
        return None
    with _profiler_lock:
        if _profiler is None:
            _profiler = CpuProfiler(
                process_class, hz=hz, publish_period_s=publish_period_s,
                publish_fn=publish_fn, metric_fn=metric_fn,
                node_id=node_id).start()
        return _profiler


def stop() -> None:
    global _profiler
    with _profiler_lock:
        prof, _profiler = _profiler, None
    if prof is not None:
        prof.stop()


def profiler() -> CpuProfiler | None:
    return _profiler


# ------------------------------------------------ folded-stack algebra

def merge_folded(records) -> dict[str, int]:
    """Sum the ``stacks`` dicts of CpuProfile ring records into one
    folded-stack aggregate."""
    merged: dict[str, int] = {}
    for record in records:
        for key, count in (record.get("stacks") or {}).items():
            merged[key] = merged.get(key, 0) + int(count)
    return merged


def render_folded(stacks: dict[str, int]) -> str:
    """Collapsed-stack text: ``stack count`` lines, heaviest first —
    pipe straight into flamegraph.pl or import into speedscope."""
    lines = [f"{key} {count}" for key, count in
             sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines)


def self_time(stacks: dict[str, int]) -> dict[str, int]:
    """Per-frame SELF samples: each folded stack's count lands on its
    leaf frame only."""
    out: dict[str, int] = {}
    for key, count in stacks.items():
        leaf = key.rsplit(";", 1)[-1]
        out[leaf] = out.get(leaf, 0) + int(count)
    return out


def diff_folded(a_stacks: dict[str, int],
                b_stacks: dict[str, int]) -> list[tuple[str, int, int, int]]:
    """Rank frames by self-time delta, B minus A: the A/B answer to
    "what got more expensive".  Returns ``(frame, delta, a, b)`` rows,
    biggest regression first, biggest improvement last."""
    a_self = self_time(a_stacks)
    b_self = self_time(b_stacks)
    rows = []
    for frame in set(a_self) | set(b_self):
        a = a_self.get(frame, 0)
        b = b_self.get(frame, 0)
        if a != b:
            rows.append((frame, b - a, a, b))
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows
