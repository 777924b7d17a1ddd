"""Pluggable tensor transports for device objects.

The port of the JAX package's ``experimental/tensor_transport.py``
(ref capability: python/ray/experimental/gpu_object_manager/
tensor_transport_manager.py:14 — the ABC each transport implements —
and collective_tensor_transport.py:36, the collective-group
implementation), with a torch tensor where it has a ``jax.Array``:

* **dma** (default, always works): the holder copies card→host, the
  bytes ride the RPC plane as one raw reply frame, and the consumer
  copies host→card — the object-store transport equivalent.  The bytes
  are the tensor's raw elements; dtype and shape come from the object's
  metadata, so bfloat16 crosses unchanged.
* **collective**: a :class:`~ant_ray_tpu_torch.parallel.spmd.ShardedTensor`
  moves SHARD BY SHARD over a ``util.collective`` group the two
  processes both joined — no single host buffer of the whole tensor
  ever materializes on the holder.  Over gloo a CUDA shard is staged
  through the host (the gloo group does that for its verbs).  The
  receiver reassembles a ShardedTensor on a mesh of the same grid shape
  on its own devices, the counterpart of
  ``jax.make_array_from_single_device_arrays``.

Selection is automatic from the metadata the producer recorded at
``device_objects.put`` time (mesh grid + collective group): a consumer
inside the group uses the collective path, anyone else falls back to
dma.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)

# One transfer at a time per (group, peer): p2p channels are ordered —
# interleaving two multi-shard transfers on one pair would cross wires.
_fetch_locks: dict = {}
_fetch_locks_guard = threading.Lock()
# Pairs whose recv watchdog expired: their p2p channel may hold a
# dangling recv, so further collective fetches from them fall back to
# dma instead of deadlocking behind the poisoned channel.
_poisoned_pairs: set = set()
# Watchdog for the recv phase when the caller gave no timeout.  The
# holder acked before any recv starts, so a healthy transfer progresses
# immediately; this only bounds a transfer whose sender died mid-way.
_RECV_DEADLINE_S = 300.0


def _pair_lock(group: str, peer: int) -> threading.Lock:
    with _fetch_locks_guard:
        return _fetch_locks.setdefault((group, peer), threading.Lock())


# Outbound transfers serialize PER DESTINATION (p2p channels are
# ordered pair-wise): a wedged consumer must only stall sends to
# itself, never the whole holder.  A module-global lock here would let
# one dead peer wedge every outbound transfer of the process.
_send_locks: dict = {}
_send_locks_guard = threading.Lock()
# Bound on one outbound transfer (lock acquisition + shard sends): on
# expiry the pair is poisoned and the send abandoned — the consumer's
# own watchdog turns the dead transfer into ObjectLost on its side.
_SEND_DEADLINE_S = 300.0


def _send_lock_for(group: str, peer: int) -> threading.Lock:
    with _send_locks_guard:
        return _send_locks.setdefault((group, peer), threading.Lock())


def clear_group(group: str) -> None:
    """Forget all per-pair transport state for ``group`` — called on
    collective-group teardown so a re-initialized group starts with a
    clean slate (stale poisoned-pair markers would dma-degrade the new
    incarnation forever; stale locks could be held by dead threads)."""
    # Snapshot before filtering: watchdog threads add() concurrently,
    # and iterating the live set would raise mid-teardown.
    _poisoned_pairs.difference_update(
        {p for p in list(_poisoned_pairs) if p[0] == group})
    with _fetch_locks_guard:
        for key in [k for k in _fetch_locks if k[0] == group]:
            del _fetch_locks[key]
    with _send_locks_guard:
        for key in [k for k in _send_locks if k[0] == group]:
            del _send_locks[key]


def _is_sharded(value: Any) -> bool:
    """A ShardedTensor, found without importing ``parallel`` (and torch)
    where the value cannot be one."""
    return (hasattr(value, "shards") and hasattr(value, "sharding")
            and hasattr(value, "full"))


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the JAX package's metadata
    names dtypes without a module prefix)."""
    return str(dtype).removeprefix("torch.")


def shards_in_mesh_order(tensor: Any) -> list:
    """The shards of a ShardedTensor in its mesh's flat cell order (C
    order of the grid) — the canonical wire order for shard-by-shard
    transfers (sender and receiver must agree; this IS the agreement)."""
    return list(tensor.shards)


def send_shards(tensor: Any, dst_rank: int, group: str,
                deadline_s: float | None = None) -> None:
    """Holder side of the collective transport: push each shard in mesh
    order over the p2p channel (called from the DeviceTensorSendVia
    RPC, off the io loop).  Failures are logged, not raised — the RPC
    already acked; the consumer's recv watchdog turns a dead transfer
    into ObjectLost + pair poisoning on its side.

    Sends serialize per destination (pair-ordered channels) and are
    bounded by ``deadline_s`` (default ``_SEND_DEADLINE_S``): a dead
    consumer poisons only its own pair instead of wedging every
    outbound transfer of this process behind one global lock."""
    from ant_ray_tpu_torch.util.collective import collective as col  # noqa: PLC0415

    budget = deadline_s if deadline_s is not None else _SEND_DEADLINE_S
    # ONE deadline for lock acquisition + sends — not budget each, so a
    # caller queued behind a stalled transfer still observes the
    # documented bound rather than up to twice it.
    deadline_at = time.monotonic() + budget
    if (group, dst_rank) in _poisoned_pairs:
        logger.warning("skipping shard send to rank %d over %r: pair is "
                       "poisoned (previous transfer stalled)",
                       dst_rank, group)
        return
    lock = _send_lock_for(group, dst_rank)
    if not lock.acquire(timeout=budget):
        _poisoned_pairs.add((group, dst_rank))
        logger.error("send lock for rank %d over %r not acquired within "
                     "%.0fs; pair poisoned", dst_rank, group, budget)
        return
    try:
        abort = threading.Event()

        def _send_all() -> None:
            for shard in shards_in_mesh_order(tensor):
                if abort.is_set():
                    return     # abandoned: stop at a shard boundary so
                    # a later incarnation of the group never sees our
                    # remaining shards interleaved into its channel
                col.send(shard.contiguous(), dst_rank, group)

        import concurrent.futures as cf  # noqa: PLC0415

        pool = cf.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(_send_all)
        try:
            fut.result(max(0.1, deadline_at - time.monotonic()))
        except cf.TimeoutError:
            abort.set()
            _poisoned_pairs.add((group, dst_rank))
            logger.error("collective shard send to rank %d over %r "
                         "stalled for %.0fs; pair poisoned, send "
                         "abandoned", dst_rank, group, budget)
        finally:
            # wait=False: an expired send thread is parked in an
            # uninterruptible send — joining it would re-wedge us.
            pool.shutdown(wait=False)
    except Exception:  # noqa: BLE001 — surfaced on the consumer side
        logger.exception("collective shard send to rank %d over %r "
                         "failed", dst_rank, group)
    finally:
        lock.release()


def shard_layout(tensor: Any) -> dict | None:
    """Producer-side transport metadata for a ShardedTensor: the mesh
    grid, its axis names and cell devices, the partition spec, and each
    shard's (flat mesh position, shape, dtype) — everything a receiver
    needs to pre-allocate recv buffers and rebuild the sharding on its
    own devices (the reference's extract_tensor_transport_metadata
    equivalent).  None for anything else, or a one-cell mesh (dma
    handles those)."""
    if not _is_sharded(tensor):
        return None
    try:
        mesh = tensor.mesh
        shards = shards_in_mesh_order(tensor)
        if mesh.size <= 1 or len(shards) != mesh.size:
            return None
        return {
            "mesh_shape": tuple(mesh.devices.shape),
            "axis_names": tuple(mesh.axis_names),
            "cell_devices": tuple(str(d) for d in mesh.cell_devices),
            "spec": tuple(tensor.spec),
            "shards": [{
                "pos": pos,
                "shape": tuple(s.shape),
                "dtype": dtype_name(s.dtype),
            } for pos, s in enumerate(shards)],
        }
    except Exception:  # noqa: BLE001 — layout probing is best-effort
        return None


def target_device(meta: dict, device=None):
    """The torch device a fetched object lands on: ``device`` where the
    caller names one, else the object's own device type (a CUDA tensor
    lands on the current CUDA device).  A CUDA object in a process
    without a card raises — it never quietly becomes a CPU tensor."""
    import torch  # noqa: PLC0415

    dev = torch.device(device if device is not None
                       else meta.get("device", "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device object {meta['token'][:12]} holds a CUDA tensor "
            f"({meta.get('dtype')}, shape {list(meta.get('shape', ()))}) "
            "and this process has no CUDA device; pass device='cpu' to "
            "fetch it to the host")
    return dev


def host_bytes(tensor: Any) -> memoryview:
    """The dma transport's holder side: the tensor's elements as raw
    bytes in host memory (a ShardedTensor assembled first, as the JAX
    package's ``np.asarray`` of a sharded array gathers it).  Blocks on
    the card→host copy: run it off the io loop."""
    import torch  # noqa: PLC0415

    if _is_sharded(tensor):
        tensor = tensor.full()
    host = tensor.detach()
    if host.device.type != "cpu":
        host = host.cpu()
    return memoryview(host.contiguous().reshape(-1).view(torch.uint8)
                      .numpy())


class TensorTransport:
    """One way of moving a device tensor holder→consumer (ref:
    tensor_transport_manager.py:14 TensorTransportManager).  ``fetch``
    places the result on ``device`` (see :func:`target_device`)."""

    name = "base"

    @staticmethod
    def can_fetch(meta: dict, runtime) -> bool:
        raise NotImplementedError

    @staticmethod
    def fetch(meta: dict, runtime, timeout: float | None,
              device=None) -> Any:
        raise NotImplementedError


class DmaTransport(TensorTransport):
    """card→host copy + RPC + host→card (the always-available
    object-store-style fallback)."""

    name = "dma"

    @staticmethod
    def can_fetch(meta: dict, runtime) -> bool:
        return True

    @staticmethod
    def fetch(meta: dict, runtime, timeout: float | None,
              device=None) -> Any:
        from ant_ray_tpu_torch import exceptions  # noqa: PLC0415

        dev = target_device(meta, device)
        try:
            host = runtime._fetch_device_tensor(
                meta["holder"], meta["token"], timeout)
        except Exception as e:  # noqa: BLE001 — holder died/unreachable
            raise exceptions.ObjectLostError(
                None, f"holder of device object {meta['token'][:12]} is "
                f"unreachable: {e}") from e
        if host is None:
            raise exceptions.ObjectLostError(
                None, f"holder no longer has device object "
                f"{meta['token'][:12]}")
        # The serializer's rebuild: dtype and shape from the metadata, a
        # tensor on ``dev`` that never aliases the reply's read buffer.
        from ant_ray_tpu_torch._private.serialization import (  # noqa: PLC0415
            _rebuild_tensor,
        )

        return _rebuild_tensor(host, meta["dtype"], tuple(meta["shape"]),
                               str(dev))


class CollectiveTransport(TensorTransport):
    """Shard-by-shard transfer over the collective group both processes
    joined (ref: collective_tensor_transport.py:36).  The consumer
    triggers the holder (RPC), then receives each shard in mesh order
    and reassembles on a local mesh of the same grid shape."""

    name = "collective"

    @staticmethod
    def can_fetch(meta: dict, runtime) -> bool:
        xfer = meta.get("collective")
        if not xfer or not meta.get("layout"):
            return False
        from ant_ray_tpu_torch.util.collective import collective as col  # noqa: PLC0415

        group = xfer["group"]
        if not col.is_group_initialized(group):
            return False
        if (group, xfer["src_rank"]) in _poisoned_pairs:
            return False               # dangling recv on this channel
        return col.get_rank(group) != xfer["src_rank"]

    @staticmethod
    def fetch(meta: dict, runtime, timeout: float | None,
              device=None) -> Any:
        import torch  # noqa: PLC0415

        from ant_ray_tpu_torch import exceptions  # noqa: PLC0415
        from ant_ray_tpu_torch.util.collective import collective as col  # noqa: PLC0415

        xfer = meta["collective"]
        layout = meta["layout"]
        group, src = xfer["group"], xfer["src_rank"]
        cells = _consumer_cells(meta, layout, device)
        my_rank = col.get_rank(group)
        with _pair_lock(group, src):
            # Kick the holder's send loop and wait for its ack BEFORE
            # parking in recv: a freed token or dead holder must raise
            # ObjectLost (like the dma path), not hang a recv that
            # nothing will ever match.
            client = runtime._clients.get(meta["holder"])
            try:
                ok = runtime._io.run_coro(client.call_async(
                    "DeviceTensorSendVia",
                    {"token": meta["token"], "group": group,
                     "dst_rank": my_rank}, timeout=30))
            except Exception as e:  # noqa: BLE001 — holder unreachable
                raise exceptions.ObjectLostError(
                    None, f"holder of device object {meta['token'][:12]} "
                    f"is unreachable: {e}") from e
            if not ok:
                raise exceptions.ObjectLostError(
                    None, f"holder no longer has device object "
                    f"{meta['token'][:12]}")

            def _recv_all() -> list:
                out = []
                for shard in layout["shards"]:
                    buf = torch.empty(shard["shape"],
                                      dtype=getattr(torch, shard["dtype"]))
                    # artlint: disable=blocking-under-lock — the pair
                    # lock SERIALIZES this send/recv rendezvous by
                    # design: it is per-(group, src), and the watchdog
                    # below bounds the park.
                    out.append(col.recv(buf, src, group))
                return out

            # Watchdog: recv has no native timeout; a sender that died
            # mid-transfer would otherwise hang this consumer (and the
            # pair lock) forever.  On expiry the pair is poisoned —
            # later fetches from it use dma.
            import concurrent.futures as cf  # noqa: PLC0415

            deadline = timeout if timeout is not None else _RECV_DEADLINE_S
            pool = cf.ThreadPoolExecutor(max_workers=1)
            fut = pool.submit(_recv_all)
            try:
                # artlint: disable=blocking-under-lock — bounded wait
                # by the recv watchdog deadline; the pair lock must
                # stay held until the collective pair is quiesced.
                host_shards = fut.result(deadline)
            except cf.TimeoutError:
                _poisoned_pairs.add((group, src))
                raise exceptions.ObjectLostError(
                    None, f"collective transfer of "
                    f"{meta['token'][:12]} from rank {src} over "
                    f"{group!r} stalled for {deadline:.0f}s; pair "
                    "poisoned, future fetches fall back to dma"
                ) from None
            finally:
                # wait=False: on expiry the recv thread is parked in an
                # uninterruptible recv — joining it would re-hang us.
                pool.shutdown(wait=False)
        if cells is None:
            # The consumer lacks the grid's devices: assemble on the
            # host instead (still a shard-wise transfer, degraded
            # placement), as the JAX package does.
            return _host_assemble(layout, host_shards, meta).to(
                target_device(meta, device))
        from ant_ray_tpu_torch.parallel import spmd  # noqa: PLC0415
        from ant_ray_tpu_torch.parallel.mesh import Mesh  # noqa: PLC0415

        import numpy as np  # noqa: PLC0415

        mesh = Mesh(np.asarray(cells, dtype=object).reshape(
            tuple(layout["mesh_shape"])), layout["axis_names"])
        sharding = spmd.NamedSharding(
            mesh, spmd.PartitionSpec(*layout["spec"]))
        shards = [data.to(dev)
                  for data, dev in zip(host_shards, mesh.cell_devices)]
        return spmd.ShardedTensor(shards, sharding, tuple(meta["shape"]))


def _consumer_cells(meta: dict, layout: dict, device) -> list | None:
    """The consumer's mesh cells, one device a cell in the holder's
    order: the holder's own cell devices where this process has them
    (or, with ``device``, every cell on that device, as a virtual mesh
    of CPU cells is built); None where it lacks them."""
    import torch  # noqa: PLC0415

    if device is not None:
        dev = target_device(meta, device)
        return [dev] * len(layout["cell_devices"])
    cells = [torch.device(d) for d in layout["cell_devices"]]
    for dev in cells:
        if dev.type == "cuda" and (
                not torch.cuda.is_available()
                or (dev.index or 0) >= torch.cuda.device_count()):
            target_device(meta)      # raises where there is no card
            return None
    return cells


def _host_assemble(layout: dict, host_shards: list, meta: dict):
    """Degraded path: rebuild the full tensor host-side from shards
    (consumer lacks the device grid).  Uses the per-cell slices implied
    by an even partition spec."""
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415

    out = torch.empty(tuple(meta["shape"]), dtype=host_shards[0].dtype)
    mesh_shape = tuple(layout["mesh_shape"])
    axis_names = tuple(layout["axis_names"])
    spec = tuple(layout["spec"])
    for s, data in zip(layout["shards"], host_shards):
        coords = np.unravel_index(s["pos"], mesh_shape)
        index = []
        for dim in range(out.ndim):
            p = spec[dim] if dim < len(spec) else None
            if p is None:
                index.append(slice(None))
                continue
            names = (p,) if isinstance(p, str) else tuple(p)
            stride = out.shape[dim]
            start = 0
            for name in names:
                k = mesh_shape[axis_names.index(name)]
                stride //= k
                start += int(coords[axis_names.index(name)]) * stride
            index.append(slice(start, start + data.shape[dim]))
        out[tuple(index)] = data
    return out


# Ordered by preference: first transport whose can_fetch passes wins.
TRANSPORTS: list[type[TensorTransport]] = [CollectiveTransport,
                                           DmaTransport]


def register_transport(transport: type[TensorTransport],
                       prepend: bool = True) -> None:
    """Plug in a custom transport (the reference's registry,
    tensor_transport_manager.py)."""
    if prepend:
        TRANSPORTS.insert(0, transport)
    else:
        TRANSPORTS.append(transport)


def select_transport(meta: dict, runtime) -> type[TensorTransport]:
    for transport in TRANSPORTS:
        try:
            if transport.can_fetch(meta, runtime):
                return transport
        except Exception:  # noqa: BLE001 — a broken plugin must not
            logger.exception("transport %s probe failed", transport.name)
    return DmaTransport
