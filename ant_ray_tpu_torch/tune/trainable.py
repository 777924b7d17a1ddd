"""Trainable abstractions: the class API and the function-trainable adapter.

Mirrors the reference's two trainable forms (ref:
python/ray/tune/trainable/trainable.py — class Trainable with
setup/step/save_checkpoint/load_checkpoint, and
python/ray/tune/trainable/function_trainable.py — a function driven on a
thread with a report queue).  The controller (tuner.py) drives either one
through the same actor surface: ``step() -> metrics dict``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

# Sentinel keys the controller understands in a step() result.
DONE = "__done__"          # trial finished (function returned / no more data)
RETURN = "__return__"      # function trainable's return value


class Trainable:
    """Class trainable: subclass and implement step() (ref:
    tune/trainable/trainable.py:119 — here without the result
    auto-population; the controller stamps training_iteration).

    ``save_checkpoint``/``load_checkpoint`` enable PBT exploitation and
    fault-tolerant trial restore; they move plain picklable state.
    """

    def setup(self, config: dict) -> None:  # noqa: B027 — optional hook
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement save_checkpoint; "
            "PBT and trial restore need it")

    def load_checkpoint(self, state: Any) -> None:
        raise NotImplementedError

    def reset_config(self, config: dict) -> bool:
        """In-place config swap (PBT explore).  Return True if handled;
        False makes the controller call setup() again."""
        return False

    def cleanup(self) -> None:  # noqa: B027 — optional hook
        pass


class _QueueSink:
    """tune.report sink that feeds the driver thread's queue."""

    def __init__(self, q: queue.Queue):
        self._q = q

    def append(self, metrics: dict) -> None:
        self._q.put(("report", dict(metrics)))


class FunctionTrainable(Trainable):
    """Adapter: runs ``fn(config)`` on a thread; each ``tune.report``
    call becomes one step() result (ref: function_trainable.py's
    _RunnerThread + result queue design)."""

    _fn: Callable | None = None  # bound by wrap_function subclassing

    def setup(self, config: dict) -> None:
        from ant_ray_tpu_torch.tune import tuner as _tuner  # noqa: PLC0415

        self._queue: queue.Queue = queue.Queue()
        self._config = config
        sink = _QueueSink(self._queue)

        def runner():
            _tuner._trial_reports.sink = sink
            try:
                ret = type(self)._fn(config)
                self._queue.put(("done", ret))
            except BaseException as e:  # noqa: BLE001 — surfaces in step()
                self._queue.put(("error", e))
            finally:
                _tuner._trial_reports.sink = None

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def step(self) -> dict:
        kind, payload = self._queue.get()
        if kind == "report":
            return payload
        if kind == "done":
            out: dict = {DONE: True}
            if isinstance(payload, dict):
                out[RETURN] = payload
            return out
        raise payload  # "error": re-raise in the actor → trial error

    def cleanup(self) -> None:
        # The runner thread is daemonic; an abandoned (early-stopped)
        # function keeps running until its next report, then blocks on an
        # unread queue put — acceptable for worker-process lifetimes,
        # identical to the reference's thread abandonment on STOP.
        pass


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass bound to ``fn`` (shipped to the
    trial actor by value via cloudpickle)."""
    return type(f"func_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
