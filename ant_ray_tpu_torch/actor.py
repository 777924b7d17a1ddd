"""Actor API: ActorClass / ActorHandle / ActorMethod
(ref: python/ray/actor.py:1228,1538)."""

from __future__ import annotations

from typing import Any

from ant_ray_tpu_torch._private.ids import ActorID
from ant_ray_tpu_torch._private.task_options import ActorOptions, TaskOptions


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        return global_worker.submit_actor_task(
            self._handle, self._method_name, args, kwargs,
            TaskOptions(num_returns=self._num_returns,
                        concurrency_group=self._concurrency_group),
        )

    def options(self, **options) -> "ActorMethod":
        num_returns = options.pop("num_returns", self._num_returns)
        group = options.pop("concurrency_group", self._concurrency_group)
        if options:
            raise ValueError(
                f"Unsupported actor-method options: {sorted(options)}")
        return ActorMethod(self._handle, self._method_name, num_returns,
                           group)

    def bind(self, *args, **kwargs):
        try:
            from ant_ray_tpu_torch.dag import ActorMethodNode  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "The DAG layer is not available in this build") from e
        return ActorMethodNode(self._handle, self._method_name, args, kwargs)


class ActorHandle:
    """Serializable handle to a running actor (ref: actor handles are
    first-class values that can be passed to other tasks/actors)."""

    def __init__(self, actor_id: ActorID, class_name: str,
                 method_names: tuple[str, ...] = (), max_concurrency: int = 1,
                 method_num_returns: dict[str, int] | None = None,
                 max_task_retries: int = 0,
                 method_concurrency_groups: dict[str, str] | None = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_names = tuple(method_names)
        self._max_concurrency = max_concurrency
        self._method_num_returns = dict(method_num_returns or {})
        self._max_task_retries = max_task_retries
        self._method_concurrency_groups = dict(method_concurrency_groups or {})

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    @property
    def class_name(self) -> str:
        return self._class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._method_names and name not in self._method_names:
            raise AttributeError(
                f"Actor {self._class_name} has no method {name!r}"
            )
        method = ActorMethod(self, name,
                             self._method_num_returns.get(name, 1),
                             self._method_concurrency_groups.get(name, ""))
        # Memoize in the instance dict: __getattr__ only fires on a
        # MISS, so every later ``handle.ping`` is a plain attribute
        # load — building a wrapper per call is measurable at 10k
        # calls/s.  (Pickling stays shape-stable: __reduce__ rebuilds
        # from ids, never from __dict__.)
        self.__dict__[name] = method
        return method

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_name, self._method_names,
             self._max_concurrency, self._method_num_returns,
             self._max_task_retries, self._method_concurrency_groups),
        )

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    """A class decorated with ``@art.remote``; instantiate with ``.remote()``."""

    def __init__(self, cls: type, options: ActorOptions | None = None):
        self._cls = cls
        self._options = options or ActorOptions()
        self._class_name = cls.__name__

    @property
    def cls(self) -> type:
        return self._cls

    @property
    def options_(self) -> ActorOptions:
        return self._options

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._class_name} cannot be instantiated directly; "
            f"use {self._class_name}.remote(...)"
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        return global_worker.create_actor(self, args, kwargs, self._options)

    def options(self, **options) -> "ActorClass":
        return ActorClass(self._cls, self._options.merged_with(**options))

    def method_names(self) -> tuple[str, ...]:
        return tuple(
            name for name in dir(self._cls)
            if callable(getattr(self._cls, name, None)) and not name.startswith("__")
        )

    def method_num_returns(self) -> dict[str, int]:
        """Per-method num_returns declared with ``@method(num_returns=N)``."""
        out = {}
        for name in self.method_names():
            n = getattr(getattr(self._cls, name), "__art_num_returns__", 1)
            if n != 1:
                out[name] = n
        return out

    def method_concurrency_groups(self) -> dict[str, str]:
        """Per-method group declared with ``@method(concurrency_group=...)``."""
        out = {}
        for name in self.method_names():
            g = getattr(getattr(self._cls, name),
                        "__art_concurrency_group__", "")
            if g:
                out[name] = g
        return out


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (ref: ray.actor.exit_actor)."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker.exit_current_actor()
