"""Trial schedulers: early stopping and population-based training.

Re-designs of the reference's scheduler set (ref:
python/ray/tune/schedulers/async_hyperband.py — ASHA,
median_stopping_rule.py, pbt.py) on a small synchronous decision API:
the controller calls ``on_trial_result`` after every reported result and
acts on the returned decision.

Decisions:
* ``CONTINUE`` / ``STOP`` — strings, self-explanatory;
* ``Exploit(source, config)`` — PBT only: clone ``source``'s checkpoint
  into this trial and continue with the mutated ``config``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

CONTINUE = "CONTINUE"
STOP = "STOP"


@dataclass(frozen=True)
class Exploit:
    source_trial_id: str
    config: dict


class TrialScheduler:
    """Base: FIFO — never stops anything early (ref: FIFOScheduler)."""

    def on_trial_add(self, trial_id: str, config: dict) -> None:
        pass

    def on_trial_result(self, trial_id: str, result: dict):
        return CONTINUE

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        pass


FIFOScheduler = TrialScheduler


def _metric_value(result: dict, metric: str, mode: str) -> float | None:
    v = result.get(metric)
    if v is None:
        return None
    return float(v) if mode == "max" else -float(v)
    # internally everything is maximize


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: asynchronous successive halving (ref: async_hyperband.py:30).

    Rungs at t = grace_period · reduction_factor^k.  When a trial reaches
    a rung, it records its metric there; it continues only if it is in
    the top 1/reduction_factor of everything recorded at that rung so
    far.  Asynchronous: decisions use whatever has been recorded, no
    waiting for a full cohort.
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 3.0,
                 time_attr: str = "training_iteration"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        if reduction_factor <= 1:
            raise ValueError("reduction_factor must be > 1 "
                             f"(got {reduction_factor})")
        if grace_period < 1 or max_t < 1:
            raise ValueError("grace_period and max_t must be >= 1 "
                             f"(got {grace_period}, {max_t})")
        self._metric, self._mode, self._time_attr = metric, mode, time_attr
        self._rf = reduction_factor
        # Rung levels, ascending, excluding max_t itself.
        self._rungs: list[tuple[int, list[float]]] = []
        t = grace_period
        while t < max_t:
            self._rungs.append((int(t), []))
            t = t * reduction_factor
        self._max_t = max_t

    def on_trial_result(self, trial_id: str, result: dict):
        t = result.get(self._time_attr, 0)
        value = _metric_value(result, self._metric, self._mode)
        if value is None or math.isnan(value):
            return CONTINUE
        if t >= self._max_t:
            return STOP
        decision = CONTINUE
        for level, recorded in self._rungs:
            if t == level:
                cutoff = self._cutoff(recorded)
                recorded.append(value)
                if cutoff is not None and value < cutoff:
                    decision = STOP
        return decision

    def _cutoff(self, recorded: list[float]) -> float | None:
        if not recorded:
            return None
        top = max(1, int(len(recorded) / self._rf))
        return sorted(recorded, reverse=True)[top - 1]


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average metric falls below the median
    of other trials' running averages at the same step (ref:
    median_stopping_rule.py:19)."""

    def __init__(self, *, metric: str, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self._metric, self._mode, self._time_attr = metric, mode, time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._completed: set[str] = set()

    def on_trial_result(self, trial_id: str, result: dict):
        value = _metric_value(result, self._metric, self._mode)
        if value is None or math.isnan(value):
            return CONTINUE
        self._sums[trial_id] = self._sums.get(trial_id, 0.0) + value
        self._counts[trial_id] = self._counts.get(trial_id, 0) + 1
        t = result.get(self._time_attr, 0)
        if t < self._grace:
            return CONTINUE
        others = [self._sums[i] / self._counts[i] for i in self._sums
                  if i != trial_id]
        if len(others) < self._min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        mine = self._sums[trial_id] / self._counts[trial_id]
        return STOP if mine < median else CONTINUE

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        self._completed.add(trial_id)


class PopulationBasedTraining(TrialScheduler):
    """PBT (ref: pbt.py:315): every ``perturbation_interval`` iterations,
    a bottom-quantile trial exploits a top-quantile trial — clones its
    checkpoint and continues with a mutated copy of its config.

    ``hyperparam_mutations``: key → list of choices or a (resample)
    callable or a tune sampler; numeric values are otherwise perturbed
    by ×1.2 / ×0.8.
    """

    def __init__(self, *, metric: str, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: int | None = None):
        if not 0.0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self._metric, self._mode, self._time_attr = metric, mode, time_attr
        self._interval = perturbation_interval
        self._mutations = dict(hyperparam_mutations or {})
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._configs: dict[str, dict] = {}
        self._scores: dict[str, float] = {}
        self._last_perturb: dict[str, int] = {}

    def on_trial_add(self, trial_id: str, config: dict) -> None:
        self._configs[trial_id] = dict(config)
        self._last_perturb[trial_id] = 0

    def on_trial_result(self, trial_id: str, result: dict):
        value = _metric_value(result, self._metric, self._mode)
        if value is not None and not math.isnan(value):
            self._scores[trial_id] = value
        t = result.get(self._time_attr, 0)
        if t - self._last_perturb.get(trial_id, 0) < self._interval:
            return CONTINUE
        lower, upper = self._quantiles()
        if not upper or len(self._scores) < 2:
            # Population not comparable yet (peers haven't reported a
            # score): DEFER — consuming the boundary here would burn
            # this trial's perturbation chance on a race it didn't
            # lose, postponing the exploit by a whole interval.
            return CONTINUE
        self._last_perturb[trial_id] = t
        if trial_id not in lower:
            return CONTINUE
        source = self._rng.choice(upper)
        new_config = self._explore(self._configs[source])
        # The config record is updated only when the controller confirms
        # the exploit (on_exploit_applied) — a failed checkpoint clone
        # must not leave the bookkeeping claiming a config the trial
        # never received.
        return Exploit(source_trial_id=source, config=new_config)

    def on_exploit_applied(self, trial_id: str, config: dict) -> None:
        self._configs[trial_id] = dict(config)

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        # A COMPLETED trial stays in the population: it remains both a
        # comparison baseline and an exploitation source (the tuner
        # snapshots its final checkpoint) — popping it here made a
        # slow-starting peer's population permanently incomparable, so
        # the peer could finish its whole run unexploited (ref: PBT
        # keeps trial state for the life of the run, pbt.py:315).
        # An ERRORED trial (result None) leaves: a crashed trial has no
        # snapshot to exploit, and its stale score would skew quantiles
        # as a phantom source forever.
        if result is None:
            self._scores.pop(trial_id, None)
            return
        value = _metric_value(result, self._metric, self._mode)
        if value is not None and not math.isnan(value):
            self._scores[trial_id] = value

    # -------------------------------------------------------- internals

    def _quantiles(self) -> tuple[list[str], list[str]]:
        scored = sorted(self._scores, key=self._scores.__getitem__)
        if len(scored) < 2:
            return [], []
        n = max(1, int(len(scored) * self._quantile))
        return scored[:n], scored[-n:]

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self._mutations.items():
            if key not in out:
                continue
            if self._rng.random() < self._resample_prob or \
                    not isinstance(out[key], (int, float)):
                out[key] = self._resample(spec, out[key])
            else:
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                val = out[key] * factor
                out[key] = int(val) if isinstance(out[key], int) else val
        return out

    def _resample(self, spec, current):
        if callable(spec):
            return spec()
        if isinstance(spec, (list, tuple)):
            return self._rng.choice(list(spec))
        sample = getattr(spec, "sample", None)  # tune samplers
        if sample is not None:
            return sample(self._rng)
        return current
