"""@remote function machinery (ref: python/ray/remote_function.py:314)."""

from __future__ import annotations

import functools
from typing import Any, Callable

from ant_ray_tpu_torch._private.task_options import TaskOptions


class RemoteFunction:
    """A function decorated with ``@art.remote``; call with ``.remote(...)``."""

    def __init__(self, function: Callable, options: TaskOptions | None = None):
        self._function = function
        self._options = options or TaskOptions()
        self._function_name = getattr(function, "__qualname__", repr(function))
        self._module = getattr(function, "__module__", "")
        functools.update_wrapper(self, function)

    @property
    def options_(self) -> TaskOptions:
        return self._options

    @property
    def function(self) -> Callable:
        return self._function

    @property
    def function_name(self) -> str:
        return f"{self._module}.{self._function_name}"

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function_name} cannot be called directly; "
            f"use {self._function_name}.remote(...)"
        )

    def remote(self, *args, **kwargs):
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        return global_worker.submit_task(self, args, kwargs, self._options)

    def options(self, **options) -> "RemoteFunction":
        return RemoteFunction(self._function, self._options.merged_with(**options))

    def bind(self, *args, **kwargs):
        """Build a DAG node (compiled-step-graph layer)."""
        try:
            from ant_ray_tpu_torch.dag import FunctionNode  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "The DAG layer is not available in this build") from e
        return FunctionNode(self, args, kwargs)
