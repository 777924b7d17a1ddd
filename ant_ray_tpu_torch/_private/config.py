"""Global configuration flag table.

Equivalent in spirit to the reference's RAY_CONFIG macro table
(ref: src/ray/common/ray_config_def.h — 239 flags, env-overridable via
RAY_<name>), redesigned as a typed dataclass: every field is overridable with
an ``ART_<NAME>`` environment variable and with the ``_system_config`` dict
passed to :func:`ant_ray_tpu_torch.init`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    # Every flag the port carries is a number.
    raw = os.environ.get(f"ART_{name.upper()}")
    return default if raw is None else type(default)(raw)


@dataclasses.dataclass
class Config:
    """The flags that the port's modules read.  The JAX package's table
    has 83; the rest belong to its cluster (transfer, scheduling, fault
    tolerance, daemons, tracing) and come with their users in ROADMAP
    queue A item 6.1b.  Until then naming one of them fails loudly."""

    # ---- object store ----
    # Per-node spill budget; past it, evictions drop instead of spill.
    max_spill_bytes: int = 10 * 1024 * 1024 * 1024

    def apply_env_overrides(self) -> "Config":
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))
        return self

    def apply_dict(self, overrides: dict | None) -> "Config":
        if not overrides:
            return self
        for key, value in overrides.items():
            if not hasattr(self, key):
                raise ValueError(
                    f"Unknown config flag: {key} (the port carries only "
                    f"{sorted(f.name for f in dataclasses.fields(self))}; "
                    "the cluster's flags come with ROADMAP queue A item "
                    "6.1b)")
            setattr(self, key, value)
        return self


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_global_config(config: Config) -> None:
    global _global_config
    _global_config = config
