"""Gloo collective group via torch.distributed — the cross-process group
over sockets (ref: python/ray/util/collective/collective_group/
torch_gloo_collective_group.py), the counterpart of the JAX package's
``collective_group/gloo_group.py`` without its jax bridge.  It takes
torch's default process group, as the reference's does, so a process
holds one live gloo group (and beside it NCCL groups, which build their
own process groups).

A CUDA tensor is staged to the host one bucket at a time, reduced there
and copied back to its card; bfloat16 buckets reduce at float32, as the
reference's do.

Rendezvous rides the GCS KV instead of a named store actor, and binds
before it advertises: rank 0 opens the TCP store on port 0 and puts the
port the kernel bound into the KV, where the others read it.  The JAX
package picks a free port first and binds it later, a window in which
another process can take it (``EADDRINUSE``); see ROADMAP §C."""

from __future__ import annotations

import datetime
import logging
import time

from ant_ray_tpu_torch.util.collective.collective_group.torch_group import (
    TorchDistGroup,
    _dist,
)

logger = logging.getLogger(__name__)

#: The host every rank reaches rank 0's store on: the reference's
#: loopback, so a group spans the processes of one host.
STORE_HOST = "127.0.0.1"


class GlooGroup(TorchDistGroup):
    _widen_bfloat16 = True

    def __init__(self, world_size: int, rank: int, group_name: str,
                 init_method: str | None = None, store=None):
        super().__init__(world_size, rank, group_name)
        import torch  # noqa: PLC0415

        dist = _dist()
        if dist.is_initialized():
            raise RuntimeError(
                "torch.distributed already initialized in this process; "
                "only one live gloo group per process is supported "
                "(destroy the existing group first)")
        if init_method is not None:
            dist.init_process_group("gloo", init_method=init_method,
                                    rank=rank, world_size=world_size)
        else:
            if store is None:
                store = rendezvous_store(group_name, rank, world_size,
                                         "gloo")
            dist.init_process_group("gloo", store=store, rank=rank,
                                    world_size=world_size)
        self._pg = dist.distributed_c10d._get_default_group()
        self._wire = torch.device("cpu")

    @classmethod
    def backend(cls):
        return "gloo"

    def destroy_group(self):
        dist = _dist()
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._rank == 0:
            forget_rendezvous(self._group_name, "gloo")

    def _new_subgroup(self, ranks: list, tag: str):
        group = _dist().new_group(ranks)
        return group if self._rank in ranks else None


def _rendezvous_key(group_name: str, kind: str) -> str:
    return f"collective:{group_name}:{kind}_store"


def rendezvous_store(group_name: str, rank: int, world_size: int,
                     kind: str, timeout_s: float = 60.0):
    """A ``torch.distributed`` store shared by the group's ranks, met
    through the GCS KV (replacing the reference's named-actor
    NCCLUniqueID rendezvous, nccl_collective_group.py:29-78).  Rank 0
    binds its TCP store to port 0 first and then advertises the port
    the kernel gave it; the other ranks poll the KV for it.  At world
    size 1 a process-local store does."""
    dist = _dist()
    timeout = datetime.timedelta(seconds=timeout_s)
    if world_size == 1:
        return dist.HashStore()
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    gcs = global_worker.runtime._gcs
    key = _rendezvous_key(group_name, kind)
    if rank == 0:
        store = dist.TCPStore(STORE_HOST, 0, world_size, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        gcs.call("KVPut", {"key": key,
                           "value": f"{STORE_HOST}:{store.port}".encode()})
        return store
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = gcs.call("KVGet", {"key": key})
        if value is not None:
            host, port = value.decode().rsplit(":", 1)
            return dist.TCPStore(host, int(port), world_size,
                                 is_master=False, timeout=timeout)
        time.sleep(0.05)
    raise TimeoutError(f"rendezvous for group {group_name!r} timed out")


def forget_rendezvous(group_name: str, kind: str) -> None:
    """Drop a destroyed group's advertised store address, so a group
    made again under the same name never reads a stale one."""
    try:
        from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

        runtime = global_worker.runtime
        if runtime is not None and getattr(runtime, "_gcs", None):
            runtime._gcs.call("KVDel", {"key": _rendezvous_key(group_name,
                                                               kind)})
    except Exception as e:  # noqa: BLE001 — the key only goes stale
        logger.debug("could not drop rendezvous key of %s: %s",
                     group_name, e)
