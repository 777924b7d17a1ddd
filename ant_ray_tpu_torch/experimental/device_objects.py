"""Device-resident objects: CUDA tensors referenced by ObjectRef.

The port of the JAX package's ``experimental/device_objects.py``
(capability mirror of the reference's "GPU objects": python/ray/
experimental/gpu_object_manager/gpu_object_manager.py:85,
gpu_object_store.py:170, tensor_transport_manager.py:14).  The payload
stays in the producing worker's card memory and moves on demand: card→
host (one copy) → RPC → host→card on the consumer.  The object plane
only ever carries small metadata (holder address, token, shape, dtype,
device type); big tensors never transit the arena unless fetched.

    ref = device_objects.put(cuda_tensor)      # metadata ObjectRef
    t = device_objects.get(ref)                # the same tensor if local

Same-process gets return the identical tensor (no copy at all).  A
ShardedTensor (``parallel/spmd.py``) additionally moves over the
pluggable COLLECTIVE transport (tensor_transport.py — shard by shard
over the processes' collective group; selected automatically from the
layout recorded at put()); the dma path is the general fallback exactly
like the reference's object-store transport.

A tensor put from the card lands on the card in the consumer; a
consumer without one raises unless it passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any


def _runtime():
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    global_worker._check_connected()
    runtime = global_worker.runtime
    if not hasattr(runtime, "_device_objects"):
        raise RuntimeError(
            "device objects need cluster mode (local_mode has no "
            "per-worker device store)")
    return runtime


def put(tensor: Any, *, transport: str = "auto",
        group_name: str = "default") -> "object":
    """Register a tensor (or a ShardedTensor) in this worker's
    device-object store; returns an ObjectRef whose payload is just
    metadata.

    The metadata carries a holder token (not the ObjectRef id): when the
    ref is passed as a task arg, the arg resolves to the metadata dict —
    which remains a fetchable handle, exactly like the reference's
    deserialized GPU-object values.

    ``transport`` mirrors the reference's per-object transport choice
    (ref: gpu_object_manager.py put(..., tensor_transport=...)):
    "auto" records collective-transport metadata when the tensor is a
    ShardedTensor AND this process is in collective group
    ``group_name`` — consumers in the group then pull shard by shard
    over it; everyone else falls back to the dma path.  "dma" skips the
    probe; "collective" requires it to apply."""
    import uuid  # noqa: PLC0415

    from ant_ray_tpu_torch.experimental.tensor_transport import (  # noqa: PLC0415
        dtype_name,
        shard_layout,
    )

    runtime = _runtime()
    token = uuid.uuid4().hex
    device = getattr(tensor, "device", None)
    meta = {
        "__art_device_object__": True,
        "holder": runtime.address,
        "token": token,
        "shape": tuple(getattr(tensor, "shape", ())),
        "dtype": dtype_name(getattr(tensor, "dtype", "")),
        "device": getattr(device, "type", "cpu"),
    }
    if transport in ("auto", "collective"):
        layout = shard_layout(tensor)
        recorded = False
        if layout is not None:
            from ant_ray_tpu_torch.util.collective import collective as col  # noqa: PLC0415

            if col.is_group_initialized(group_name):
                meta["layout"] = layout
                meta["collective"] = {
                    "group": group_name,
                    "src_rank": col.get_rank(group_name)}
                recorded = True
        if transport == "collective" and not recorded:
            raise ValueError(
                "transport='collective' needs a ShardedTensor and an "
                f"initialized collective group {group_name!r}")
    elif transport != "dma":
        raise ValueError(f"unknown transport {transport!r}")
    ref = runtime.put(meta)
    runtime._device_objects[token] = tensor
    # Payload lifetime rides the metadata object's refcount: when the
    # owner frees the metadata (all refs/borrows gone), the card entry
    # is dropped too.  A grace pin covers the window between returning
    # the ref from a task and the consumer's borrow registration.
    runtime._device_tokens_by_oid[ref.id] = token
    runtime.pin_for_grace(ref)
    return ref


def get(ref_or_meta, timeout: float | None = None, *,
        device=None) -> Any:
    """Resolve a device ObjectRef (or its resolved metadata dict, as
    seen inside a task that received the ref as an argument) to a
    tensor in this process.

    Local hit → the original tensor (zero copy).  Remote → the selected
    transport moves it here, onto ``device`` (default: the object's own
    device type; a CUDA object where this process has no card raises
    unless ``device="cpu"``).
    """
    runtime = _runtime()
    meta = _resolve_meta(runtime, ref_or_meta, timeout)
    local = runtime._device_objects.get(meta["token"])
    if local is not None:
        return local
    from ant_ray_tpu_torch.experimental.tensor_transport import (  # noqa: PLC0415
        select_transport,
    )

    return select_transport(meta, runtime).fetch(meta, runtime, timeout,
                                                 device=device)


def free(ref_or_meta) -> None:
    """Drop the device payload (metadata object follows normal ref
    counting)."""
    runtime = _runtime()
    meta = _resolve_meta(runtime, ref_or_meta, 5)
    if runtime._device_objects.pop(meta["token"], None) is not None:
        return
    runtime._send_oneway(meta["holder"], "DeviceTensorFree",
                         {"token": meta["token"]})


def _resolve_meta(runtime, ref_or_meta, timeout) -> dict:
    meta = ref_or_meta
    if not isinstance(meta, dict):
        meta = runtime.get([ref_or_meta], timeout)[0]
    if not (isinstance(meta, dict) and meta.get("__art_device_object__")):
        raise TypeError("not a device ObjectRef / device-object metadata")
    return meta
