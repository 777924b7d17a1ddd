"""Implicit init on first API use (ref: ray auto-init semantics)."""

from __future__ import annotations

import os


def auto_init() -> None:
    from ant_ray_tpu_torch import api  # noqa: PLC0415
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    if global_worker.connected:
        return
    address = os.environ.get("ART_ADDRESS")
    api.init(address=address, ignore_reinit_error=True)
