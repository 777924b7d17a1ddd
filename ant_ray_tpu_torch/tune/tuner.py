"""Tuner: the trial-driving controller event loop.

Mirror of the reference architecture (SURVEY §2.4 Tune: Tuner →
TuneController event loop over trial actors, searchers, schedulers; ref
python/ray/tune/execution/tune_controller.py): a Searcher suggests
configs, each trial runs as an actor stepped by the controller, every
reported result flows through the TrialScheduler (ASHA / median rule /
PBT — schedulers.py) which may stop the trial early or, for PBT, clone a
better trial's checkpoint into it, and the ResultGrid picks winners.

Function trainables are adapted onto the same step() surface by running
on a thread inside the trial actor (trainable.py) — each ``tune.report``
call becomes one controller-visible result.

The port of the JAX package's ``tune/tuner.py``: the same controller on
this package's runtime, drawing from ``random.Random(seed)`` call for
call as that module does, so a seeded search expands to the same configs.
"""

from __future__ import annotations

import itertools
import logging
import random as _random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ search space

@dataclass(frozen=True)
class _GridSearch:
    values: tuple


@dataclass(frozen=True)
class _Sampler:
    kind: str
    a: float
    b: float
    values: tuple = ()

    def sample(self, rng: _random.Random):
        if self.kind == "uniform":
            return rng.uniform(self.a, self.b)
        if self.kind == "loguniform":
            import math

            return math.exp(rng.uniform(math.log(self.a), math.log(self.b)))
        if self.kind == "randint":
            return rng.randint(int(self.a), int(self.b) - 1)
        if self.kind == "choice":
            return rng.choice(list(self.values))
        raise ValueError(self.kind)


def grid_search(values) -> _GridSearch:
    return _GridSearch(tuple(values))


def uniform(low: float, high: float) -> _Sampler:
    return _Sampler("uniform", low, high)


def loguniform(low: float, high: float) -> _Sampler:
    return _Sampler("loguniform", low, high)


def randint(low: int, high: int) -> _Sampler:
    return _Sampler("randint", low, high)


def choice(values) -> _Sampler:
    return _Sampler("choice", 0, 0, tuple(values))


def expand_param_space(space: dict, num_samples: int,
                       seed: int | None = None) -> list[dict]:
    """Grid dims form the cross product; samplers draw per sample."""
    rng = _random.Random(seed)
    grid_keys = [k for k, v in space.items() if isinstance(v, _GridSearch)]
    grid_values = [space[k].values for k in grid_keys]
    grids = list(itertools.product(*grid_values)) if grid_keys else [()]
    configs = []
    for _ in range(num_samples):
        for combo in grids:
            config = {}
            for key, value in space.items():
                if isinstance(value, _GridSearch):
                    config[key] = combo[grid_keys.index(key)]
                elif isinstance(value, _Sampler):
                    config[key] = value.sample(rng)
                else:
                    config[key] = value
            configs.append(config)
    return configs


# ------------------------------------------------------------ reporting

_trial_reports = threading.local()


def report(metrics: dict) -> None:
    """In-trial metric reporting (ref: tune.report / session.report)."""
    sink = getattr(_trial_reports, "sink", None)
    if sink is None:
        raise RuntimeError("tune.report() called outside a trial")
    sink.append(dict(metrics))


class _TrialActor:
    """The per-trial actor: hosts one Trainable and exposes the
    step/save/restore surface the controller drives (ref: the trainable
    actor in tune_controller.py)."""

    def __init__(self, trainable_cls: type, config: dict):
        self._cls = trainable_cls
        self._config = dict(config)
        self._t = trainable_cls()
        self._t.setup(dict(config))

    def step(self) -> dict:
        return self._t.step()

    def save(self):
        return self._t.save_checkpoint()

    def restore(self, state, config: dict | None = None) -> None:
        if config is not None and config != self._config:
            if not self._t.reset_config(dict(config)):
                self._t.cleanup()
                self._t = self._cls()
                self._t.setup(dict(config))
            self._config = dict(config)
        self._t.load_checkpoint(state)

    def shutdown(self) -> None:
        self._t.cleanup()


# ------------------------------------------------------------ results

@dataclass
class Result:
    config: dict
    metrics: dict
    history: list = field(default_factory=list)
    error: Exception | None = None


class ResultGrid:
    def __init__(self, results: list[Result]):
        self._results = results

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self) -> list[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: str, mode: str = "min") -> Result:
        scored = [r for r in self._results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise ValueError(f"no successful trial reported {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return min(scored, key=key) if mode == "min" else max(scored,
                                                              key=key)

    def get_dataframe(self):
        rows = [{**r.config, **r.metrics} for r in self._results
                if r.error is None]
        return rows


# ------------------------------------------------------------ tuner

@dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 0       # 0 = unbounded
    metric: str | None = None
    mode: str = "min"
    seed: int | None = None
    resources_per_trial: dict = field(default_factory=dict)
    scheduler: Any = None                # TrialScheduler (schedulers.py)
    search_alg: Any = None               # Searcher (search.py)
    stop: dict | None = None             # e.g. {"training_iteration": 8}


@dataclass
class _Trial:
    id: str
    config: dict
    actor: Any
    iter: int = 0
    history: list = field(default_factory=list)
    last: dict = field(default_factory=dict)


class Tuner:
    """(ref: python/ray/tune/tuner.py:43)"""

    def __init__(self, trainable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None):
        self._trainable = trainable
        self._param_space = dict(param_space or {})
        self._config = tune_config or TuneConfig()

    def _trainable_cls(self) -> type:
        from ant_ray_tpu_torch.tune.trainable import (  # noqa: PLC0415
            Trainable,
            wrap_function,
        )

        if isinstance(self._trainable, type) and \
                issubclass(self._trainable, Trainable):
            return self._trainable
        if callable(self._trainable):
            return wrap_function(self._trainable)
        raise TypeError(f"trainable must be a callable or Trainable "
                        f"subclass, got {type(self._trainable)}")

    def fit(self) -> ResultGrid:
        import ant_ray_tpu_torch as art  # noqa: PLC0415
        from ant_ray_tpu_torch.tune import schedulers as _sched  # noqa: PLC0415
        from ant_ray_tpu_torch.tune.search import (  # noqa: PLC0415
            BasicVariantGenerator)
        from ant_ray_tpu_torch.tune.trainable import (  # noqa: PLC0415
            DONE,
            RETURN,
            FunctionTrainable,
        )

        if not art.is_initialized():
            art.init()
        cfg = self._config
        searcher = cfg.search_alg or BasicVariantGenerator(
            self._param_space, cfg.num_samples, cfg.seed)
        scheduler = cfg.scheduler or _sched.FIFOScheduler()
        trainable_cls = self._trainable_cls()
        if isinstance(scheduler, _sched.PopulationBasedTraining) and \
                issubclass(trainable_cls, FunctionTrainable):
            raise ValueError(
                "PopulationBasedTraining exploits trial checkpoints — it "
                "requires a class Trainable implementing save_checkpoint/"
                "load_checkpoint, not a function trainable")
        actor_opts = ({"resources": cfg.resources_per_trial}
                      if cfg.resources_per_trial else {})
        actor_cls = art.remote(_TrialActor).options(**actor_opts)

        max_conc = cfg.max_concurrent_trials or 16
        results: list[Result] = []
        trials: dict[str, _Trial] = {}        # running, by id
        step_refs: dict = {}                  # outstanding step ref → id
        exhausted = False
        next_id = 0

        def _launch() -> bool:
            nonlocal next_id, exhausted
            tid = f"trial_{next_id}"
            config = searcher.suggest(tid)
            if config is None:
                exhausted = True
                return False
            next_id += 1
            actor = actor_cls.remote(trainable_cls, config)
            trial = _Trial(id=tid, config=config, actor=actor)
            trials[tid] = trial
            scheduler.on_trial_add(tid, config)
            step_refs[actor.step.remote()] = tid
            return True

        final_states: dict[str, object] = {}  # tid -> checkpoint state
        pbt_active = isinstance(scheduler, _sched.PopulationBasedTraining)

        def _finish(trial: _Trial, *, error: Exception | None = None):
            trials.pop(trial.id, None)
            if error is None and pbt_active:
                # Snapshot the final checkpoint BEFORE killing the
                # actor: a still-running PBT peer may exploit this
                # completed trial later.  Only PBT reads these — for
                # ASHA/FIFO sweeps a per-trial full-state snapshot
                # would be pure driver-memory bloat.
                try:
                    final_states[trial.id] = art.get(
                        trial.actor.save.remote())
                except Exception:  # noqa: BLE001 — actor already gone
                    pass
            scheduler.on_trial_complete(trial.id,
                                        None if error else trial.last)
            searcher.on_trial_complete(trial.id,
                                       None if error else trial.last,
                                       error=error is not None)
            results.append(Result(config=trial.config, metrics=trial.last
                                  if error is None else {},
                                  history=trial.history, error=error))
            try:
                art.kill(trial.actor)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass

        def _should_stop(trial: _Trial, result: dict) -> bool:
            for key, bound in (cfg.stop or {}).items():
                if result.get(key) is not None and result[key] >= bound:
                    return True
            return False

        while not exhausted or step_refs:
            while not exhausted and len(trials) < max_conc:
                if not _launch():
                    break
            if not step_refs:
                break
            ready, _ = art.wait(list(step_refs), num_returns=1, timeout=300)
            for ref in ready:
                tid = step_refs.pop(ref)
                trial = trials.get(tid)
                if trial is None:
                    continue
                try:
                    result = art.get(ref)
                except Exception as e:  # noqa: BLE001 — trial failure
                    _finish(trial, error=e)
                    continue
                if result.get(DONE):
                    ret = result.get(RETURN)
                    if isinstance(ret, dict):
                        trial.last = {**trial.last, **ret}
                    _finish(trial)
                    continue
                trial.iter += 1
                result.setdefault("training_iteration", trial.iter)
                trial.history.append(dict(result))
                trial.last = dict(result)
                if _should_stop(trial, result):
                    _finish(trial)
                    continue
                decision = scheduler.on_trial_result(tid, result)
                if decision == _sched.STOP:
                    _finish(trial)
                    continue
                if isinstance(decision, _sched.Exploit):
                    source = trials.get(decision.source_trial_id)
                    cached = final_states.get(decision.source_trial_id)
                    try:
                        if source is not None:
                            state = art.get(source.actor.save.remote())
                        else:
                            state = cached  # completed source (or None)
                        if state is not None:
                            art.get(trial.actor.restore.remote(
                                state, decision.config))
                            trial.config = decision.config
                            applied = getattr(scheduler,
                                              "on_exploit_applied", None)
                            if applied is not None:
                                applied(tid, decision.config)
                    except Exception as e:  # noqa: BLE001
                        logger.warning(
                            "PBT exploit of %s from %s failed "
                            "(%r); trial continues unperturbed",
                            tid, decision.source_trial_id, e)
                step_refs[trial.actor.step.remote()] = tid
        return ResultGrid(results)
