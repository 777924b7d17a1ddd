"""Client↔server value encoding — ONE definition for both ends.

Values cross the proxy as the object plane's own serialized payloads
(pickle-5 + out-of-band buffers), so the wire format changes in exactly
one place.  Unlike the JAX package's proxy, the server never rebuilds a
value the client sends: a packed value carries the refs found inside it
beside its payload, and the server stores or forwards the payload as it
is.  A CUDA tensor that a client puts or gets is therefore built only
at its ends, never in the proxy (which needs no card).
"""

from __future__ import annotations

from typing import Any, Callable

from ant_ray_tpu_torch._private import serialization


def pack(value: Any) -> dict:
    """``value``'s payload and the (object id, owner) of each ObjectRef
    inside it."""
    ser = serialization.serialize(value)
    return {"payload": ser.to_payload(),
            "refs": [(r.id, r.owner_address) for r in ser.contained_refs]}


def unpack(payload) -> Any:
    return serialization.deserialize(
        serialization.SerializedObject.from_payload(payload))


def serialized(packed: dict, resolve: Callable) -> serialization.SerializedObject:
    """Server side: the serialized value of a packed one, its payload
    untouched, with its refs resolved by ``resolve(wire)``."""
    ser = serialization.SerializedObject.from_payload(packed["payload"])
    ser.contained_refs = [resolve(w) for w in packed["refs"]]
    return ser
