"""What a driver hands back: the record that the metric readers read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Served:
    """One request as its client saw it (host monotonic seconds)."""

    index: int
    due: float                      # when it was due to be sent
    prompt_len: int
    max_tokens: int
    token_times: list = field(default_factory=list)  # each token's arrival
    done: float | None = None       # final event, if inside the window
    error: str | None = None
    tokens: list | None = None      # served token ids, once done


@dataclass
class EngineStep:
    """One engine step inside the traced window: its wall and phases
    (the program's StepProfiler record), what it prefilled and the
    contexts of the slots it decoded."""

    total_s: float
    phases: dict
    prefills: list = field(default_factory=list)   # [(bucket, tokens)]
    decode_contexts: list | None = None


@dataclass
class TrainStep:
    start: float
    end: float
    tokens: int
    loss: float


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    counts: Any = None              # counts.Decoder | counts.Gpt2
    setup_s: float = 0.0
    setup_split: dict = field(default_factory=dict)
    window_start: float = 0.0
    window_close: float = 0.0
    served: list = field(default_factory=list)       # [Served]
    train_steps: list = field(default_factory=list)  # [TrainStep]
    steps: list = field(default_factory=list)        # traced [EngineStep]
    trace: Any = None               # trace.Trace, in a traced run
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: dict = field(default_factory=dict)       # name -> (value, limit)
    notes: list = field(default_factory=list)        # lines for stderr

    @property
    def window_s(self) -> float:
        return self.window_close - self.window_start

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            value is not None and value <= limit
            for value, limit in self.checks.values())
