"""Per-step phase profiler for training/inference loops (a copy of the
local part of ant_ray_tpu/observability/step_profiler.py, which the port
does not import).

Phases are attributions, not a schedule: explicit
``with profiler.phase(name):`` blocks attribute their wall time to
``name``, and ``compute`` — unless explicitly timed — is derived as the
un-attributed remainder of the step.  The LLM engine times ``prefill``,
``decode`` and ``restore_install``.  All times are host clocks: around
asynchronous device work a phase ends when its launches are queued,
unless something inside it waits for the device.

Cost model: the step path is two ``perf_counter`` reads, a wall-clock
read, and a raw ``(step, ts, total, phases)`` tuple appended to a
bounded deque — records materialize into :class:`StepRecord` objects and
the MFU / compute-remainder math runs only when something *reads* them
(``last``, ``summary()``, a batch flush).

Publishing: with ``publish=True`` (the default) finished steps gather in
a pending batch; every ``publish_batch`` steps, and on :meth:`flush` or
:meth:`close`, the batch goes to the GCS step-events table
(``StepEventsAdd``) as :meth:`StepRecord.as_dict` rows, which
``util/timeline.py`` renders as per-rank device rows.  Best-effort, as
in the reference: outside a cluster the batch is dropped.

MFU needs the card's peak: without ``peak_flops`` the profiler looks up
the current CUDA device's name in :data:`PEAK_BF16_FLOPS` (the reference
reads a TPU table); on the CPU or an unlisted card MFU stays None, as in
the reference off a TPU.

Not in the port yet (ROADMAP.md): the attached stats streams of a device
feed and of collective fusion (queue A items 6.5 and 7), and the train
session's rank (records carry rank 0).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import torch

# Dense bf16 peak FLOP/s by torch.cuda.get_device_name() (NVIDIA's data
# sheet, SXM part, at the full 700 W power limit).
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


@dataclass
class StepRecord:
    """One completed step: wall-clock placement + phase attribution."""

    step: int
    start_ts: float                  # wall clock (time.time) at entry
    total_s: float
    phases: dict                     # phase -> seconds (attributed)
    mfu: float | None = None
    rank: int = 0

    def fraction(self, phase: str) -> float:
        if self.total_s <= 0:
            return 0.0
        return min(1.0, self.phases.get(phase, 0.0) / self.total_s)

    def as_dict(self) -> dict:
        return {"step": self.step, "ts": self.start_ts,
                "total_s": self.total_s, "phases": dict(self.phases),
                "mfu": self.mfu, "rank": self.rank}

    @classmethod
    def from_dict(cls, d: dict) -> "StepRecord":
        return cls(step=int(d.get("step", 0)),
                   start_ts=float(d.get("ts", 0.0)),
                   total_s=float(d.get("total_s", 0.0)),
                   phases=dict(d.get("phases") or {}),
                   mfu=d.get("mfu"), rank=int(d.get("rank", 0)))


class _PhaseTimer:
    """Reusable context manager — one per phase name, allocated once."""

    __slots__ = ("_prof", "_name", "_t0")

    def __init__(self, prof: "StepProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        phases = self._prof._cur_phases
        phases[self._name] = (phases.get(self._name, 0.0)
                              + time.perf_counter() - self._t0)
        return False


class StepProfiler:
    """Record per-step phase timings; see the module docstring.

    Usage::

        prof = StepProfiler()
        engine = LLMEngine(..., profiler=prof)   # or, in a custom loop:
        with prof.step():
            with prof.phase("decode"):
                ...
        prof.summary()

    ``flops_per_step`` enables MFU, against ``peak_flops`` (the card's
    peak for the step's dtype) or, without it, the current card's bf16
    peak from :data:`PEAK_BF16_FLOPS`.  A process steps on one card, so
    the peak is one card's (the reference sums the host's TPU chips,
    which one JAX process drives together).
    """

    __slots__ = ("_flops_per_step", "_peak_flops", "records", "_publish",
                 "_publish_batch", "_pending", "_step_index",
                 "_cur_phases", "_t0", "_wall0", "_timers")

    def __init__(self, *, flops_per_step: float | None = None,
                 peak_flops: float | None = None, history: int = 256,
                 publish: bool = True, publish_batch: int = 64):
        self._flops_per_step = flops_per_step
        self._peak_flops = (peak_flops if peak_flops is not None
                            else self._detect_peak_flops())
        # raw (step, wall_ts, total_s, phases) tuples — materialized
        # into StepRecords only on read, keeping the step path cheap
        self.records: Any = deque(maxlen=max(1, history))
        self._publish = publish
        self._publish_batch = max(1, publish_batch)
        self._pending: list[tuple] = []
        self._step_index = 0
        self._cur_phases: dict[str, float] = {}
        self._t0 = 0.0
        self._wall0 = 0.0
        self._timers: dict[str, _PhaseTimer] = {}

    @staticmethod
    def _detect_peak_flops() -> float | None:
        if not torch.cuda.is_available():
            return None             # off the card: MFU needs peak_flops=
        return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name())

    # -------------------------------------------------------- step path

    def step(self) -> "StepProfiler":
        """``with profiler.step():`` wraps exactly one step."""
        return self

    def __enter__(self):
        self._cur_phases = {}
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        total = time.perf_counter() - self._t0
        rec = (self._step_index, self._wall0, total, self._cur_phases)
        self._step_index += 1
        self.records.append(rec)
        if self._publish:
            pending = self._pending
            pending.append(rec)
            if len(pending) >= self._publish_batch:
                self.flush()
        return False

    def phase(self, name: str) -> _PhaseTimer:
        """``with profiler.phase("decode"):`` attributes the block's
        wall time to that phase."""
        timer = self._timers.get(name)
        if timer is None:
            timer = self._timers[name] = _PhaseTimer(self, name)
        return timer

    # -------------------------------------------------- materialization

    def _raw_to_dict(self, raw: tuple) -> dict:
        step, wall0, total, phases = raw
        phases = dict(phases)
        if "compute" not in phases:
            # The un-attributed remainder of the step.
            phases["compute"] = max(0.0, total - sum(phases.values()))
        mfu = None
        if self._flops_per_step and self._peak_flops and total > 0:
            mfu = self._flops_per_step / (total * self._peak_flops)
        return {"step": step, "ts": wall0, "total_s": total,
                "phases": phases, "mfu": mfu, "rank": 0}

    def _materialize(self, raw: tuple) -> StepRecord:
        return StepRecord.from_dict(self._raw_to_dict(raw))

    # ------------------------------------------------------- publishing

    def flush(self) -> None:
        """Batch-publish pending records to the GCS step-events table.
        Best-effort: outside a cluster the batch is dropped (the
        profiler stays a cheap local instrument, metrics-style)."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        try:
            from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

            if not global_worker.connected:
                return
            runtime = global_worker.runtime
            if getattr(runtime, "_gcs", None) is None:
                return              # local mode
            runtime._send_oneway(
                runtime.gcs_address, "StepEventsAdd",
                {"records": [self._raw_to_dict(r) for r in batch]})
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    # --------------------------------------------------------- analysis

    @property
    def last(self) -> StepRecord | None:
        return self._materialize(self.records[-1]) if self.records \
            else None

    def step_records(self) -> list[StepRecord]:
        """The retained window as materialized records."""
        return [self._materialize(r) for r in self.records]

    def summary(self) -> dict:
        """Aggregate over the retained window: step-time mean/p50/max,
        mean phase fractions, mean MFU."""
        records = self.step_records()
        if not records:
            return {"steps": 0}
        times = sorted(r.total_s for r in records)
        n = len(times)
        out: dict = {
            "steps": records[-1].step + 1,
            "window": n,
            "step_time_mean_s": sum(times) / n,
            "step_time_p50_s": (times[(n - 1) // 2] + times[n // 2]) / 2,
            "step_time_max_s": times[-1],
        }
        names: set = set()
        for r in records:
            names.update(r.phases)
        for name in sorted(names):
            out[f"phase_{name}_fraction"] = (
                sum(r.fraction(name) for r in records) / n)
        mfus = [r.mfu for r in records if r.mfu is not None]
        if mfus:
            out["mfu_mean"] = sum(mfus) / len(mfus)
        return out

    def close(self) -> None:
        self.flush()
