"""Searchers: config suggestion strategies.

Mirrors the reference's Searcher interface (ref:
python/ray/tune/search/searcher.py — suggest/on_trial_complete) with two
built-ins: BasicVariantGenerator (grid × random, the default) and a
dependency-free TPE-style searcher (ref capability:
tune/search/hyperopt — here re-implemented as an independent
good/bad-density ratio over each dimension, no hyperopt import).
"""

from __future__ import annotations

import math
import random
from typing import Any

from ant_ray_tpu_torch.tune.tuner import (
    _GridSearch,
    _Sampler,
    expand_param_space,
)


class Searcher:
    def suggest(self, trial_id: str) -> dict | None:
        """Next config, or None when the search space is exhausted."""
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:  # noqa: B027
        pass


class BasicVariantGenerator(Searcher):
    """Pre-expanded grid × random variants (ref:
    tune/search/basic_variant.py)."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self._configs = expand_param_space(param_space, num_samples, seed)
        self._next = 0

    def suggest(self, trial_id: str) -> dict | None:
        if self._next >= len(self._configs):
            return None
        config = self._configs[self._next]
        self._next += 1
        return config


class TPESearcher(Searcher):
    """Tree-structured-Parzen-lite: after ``n_initial`` random draws,
    split observations at the ``gamma`` quantile into good/bad sets and
    pick the candidate maximizing the good/bad kernel-density ratio,
    independently per dimension.

    Works on numeric (``uniform``/``loguniform``/``randint``) and
    ``choice`` dimensions; grid dimensions are rejected (use
    BasicVariantGenerator for grids).
    """

    def __init__(self, param_space: dict, *, metric: str,
                 mode: str = "min", num_samples: int = 64,
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int | None = None):
        for key, value in param_space.items():
            if isinstance(value, _GridSearch):
                raise ValueError(
                    f"TPESearcher does not support grid_search ({key!r})")
        self._space = dict(param_space)
        self._metric, self._mode = metric, mode
        self._budget = num_samples
        self._n_initial = n_initial
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested = 0
        self._pending: dict[str, dict] = {}
        self._observed: list[tuple[dict, float]] = []

    # ---------------------------------------------------------- public

    def suggest(self, trial_id: str) -> dict | None:
        if self._suggested >= self._budget:
            return None
        self._suggested += 1
        if len(self._observed) < self._n_initial:
            config = self._random_config()
        else:
            config = self._tpe_config()
        self._pending[trial_id] = config
        return config

    def on_trial_complete(self, trial_id: str, result: dict | None,
                          error: bool = False) -> None:
        config = self._pending.pop(trial_id, None)
        if config is None or error or not result:
            return
        value = result.get(self._metric)
        if value is None:
            return
        score = float(value) if self._mode == "min" else -float(value)
        self._observed.append((config, score))

    # -------------------------------------------------------- internals

    def _random_config(self) -> dict:
        config = {}
        for key, value in self._space.items():
            config[key] = value.sample(self._rng) if \
                isinstance(value, _Sampler) else value
        return config

    def _tpe_config(self) -> dict:
        ranked = sorted(self._observed, key=lambda cv: cv[1])
        n_good = max(1, int(len(ranked) * self._gamma))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        best, best_score = None, -math.inf
        for _ in range(self._n_candidates):
            cand = self._mutate_from(good)
            score = self._density_ratio(cand, good, bad)
            if score > best_score:
                best, best_score = cand, score
        return best if best is not None else self._random_config()

    def _mutate_from(self, good: list[dict]) -> dict:
        """Sample each dim from a kernel around a random good point."""
        base = self._rng.choice(good)
        config = {}
        for key, spec in self._space.items():
            if not isinstance(spec, _Sampler):
                config[key] = spec
                continue
            if spec.kind == "choice":
                config[key] = (base[key] if self._rng.random() < 0.7
                               else spec.sample(self._rng))
            elif spec.kind == "randint":
                lo, hi = int(spec.a), int(spec.b)
                width = max(1, (hi - lo) // 5)
                value = base[key] + self._rng.randint(-width, width)
                config[key] = min(hi - 1, max(lo, value))
            else:
                lo, hi = spec.a, spec.b
                log = spec.kind == "loguniform"
                b = math.log(base[key]) if log else base[key]
                span = (math.log(hi) - math.log(lo)) if log else (hi - lo)
                value = self._rng.gauss(b, span / 10)
                if log:
                    value = math.exp(value)
                config[key] = min(hi, max(lo, value))
        return config

    def _density_ratio(self, cand: dict, good: list[dict],
                       bad: list[dict]) -> float:
        total = 0.0
        for key, spec in self._space.items():
            if not isinstance(spec, _Sampler):
                continue
            total += math.log(self._kde(cand[key], key, spec, good) + 1e-12)
            total -= math.log(self._kde(cand[key], key, spec, bad) + 1e-12)
        return total

    def _kde(self, value: Any, key: str, spec: _Sampler,
             points: list[dict]) -> float:
        if spec.kind == "choice":
            hits = sum(1 for p in points if p[key] == value)
            return (hits + 0.5) / (len(points) + 0.5 * len(spec.values))
        log = spec.kind == "loguniform"
        lo, hi = spec.a, spec.b
        span = (math.log(hi) - math.log(lo)) if log else float(hi - lo)
        h = max(span / 8, 1e-9)
        x = math.log(value) if log else float(value)
        total = 0.0
        for p in points:
            px = math.log(p[key]) if log else float(p[key])
            total += math.exp(-0.5 * ((x - px) / h) ** 2)
        return total / (len(points) * h * math.sqrt(2 * math.pi))
