"""The one traffic generator: it reads a traffic file's parameters and
makes a run's requests from ``--seed``.

Request sizes and arrival gaps are drawn once from the file's
``shape_seed``; the run's seed draws the token ids (and, in a closed
loop, the order of the sizes).  So two seeds offer the same work, and
the spread between seeds is the system's, not the draw's.

Loops:

* ``open``: ``rate_per_s`` x ``--seconds`` requests arrive inside the
  window.  Their gaps are exponential (a Poisson process given its
  count), scaled so that the last gap ends at the window's close.  The
  schedule (each request's send time and sizes) is the same for every
  seed: a burst is part of the cell, not of the seed.
* ``closed``: ``clients`` clients each send their next request when the
  last one has finished.  The requests come from successive orderings,
  drawn from the seed, of one block of ``block`` sizes, so any
  ``block`` consecutive requests hold the same sizes.

A length distribution is ``{"dist": "lognormal", "median", "sigma",
"min", "max"}``, ``{"dist": "uniform", "min", "max"}`` (whole numbers,
both ends included) or ``{"dist": "fixed", "value"}``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int
    at_s: float | None        # its send time in the window (open loop)
    prompt: np.ndarray        # int64 token ids
    max_tokens: int


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) & 0xFFFFFFFFFFFFFFFF for k in key])


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "uniform":
        return rng.integers(int(spec["min"]), int(spec["max"]) + 1, n)
    if kind == "lognormal":
        raw = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
        return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def _sizes(traffic: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = _rng(traffic["shape_seed"], 1)
    return (lengths(traffic["prompt_tokens"], n, rng),
            lengths(traffic["output_tokens"], n, rng))


def open_loop(traffic: dict, seed: int, seconds: float,
              vocab: int) -> list[Request]:
    """The requests of an open loop, in send order."""
    n = max(1, int(round(traffic["rate_per_s"] * seconds)))
    prompts, outputs = _sizes(traffic, n)
    gaps = _rng(traffic["shape_seed"], 2).exponential(1.0, n + 1)
    gaps *= seconds / gaps.sum()
    at = np.cumsum(gaps)[:n]
    tokens = _rng(seed, 4)
    return [Request(i, float(at[i]),
                    tokens.integers(0, vocab, int(prompts[i])),
                    int(outputs[i]))
            for i in range(n)]


class ClosedLoop:
    """The request stream of a closed loop: ``next()`` is thread-safe
    only under the caller's lock."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.block = int(traffic["block"])
        self.prompts, self.outputs = _sizes(traffic, self.block)
        self._order = _rng(seed, 3)
        self._tokens = _rng(seed, 4)
        self._vocab = vocab
        self._pick = np.empty(0, np.int64)
        self._next = 0

    def next(self) -> Request:
        i = self._next
        if i % self.block == 0:
            self._pick = self._order.permutation(self.block)
        j = self._pick[i % self.block]
        self._next += 1
        return Request(i, None,
                       self._tokens.integers(0, self._vocab,
                                             int(self.prompts[j])),
                       int(self.outputs[j]))
